"""The port's host math, data, tree utilities, optimizers and models against
the JAX package, on the same numpy-seeded inputs.

Host math and data are numpy copies, so they must match exactly; losses,
gradients and optimizer updates are f32 device math and match within 1e-6.
Also the import guard: nothing under src/repro_torch/, and not
chip_smoke.py, imports jax or the JAX package.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro.core import convergence as jconv
from repro.core import design as jdesign
from repro.core import privacy as jpriv
from repro.models import linear as jlin
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.utils import tree as jtree
from repro_torch import data as tdata
from repro_torch.core import convergence as tconv
from repro_torch.core import design as tdesign
from repro_torch.core import privacy as tpriv
from repro_torch.models import linear as tlin
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.utils import tree as ttree
from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy

ROOT = Path(__file__).resolve().parents[1]


def _eq_trees(a, b):
    la, lb = jax.tree.leaves(a), ttree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        y = y.numpy() if isinstance(y, torch.Tensor) else y
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ------------------------------- data ---------------------------------------

@pytest.mark.parametrize("make", [
    lambda m: m.adult_like(n=3000, dim=24, seed=3),
    lambda m: m.vehicle_like(n_sensors=5, per_sensor=120, dim=12, seed=2),
])
def test_synthetic_datasets_identical(make):
    a, b = make(jdata), make(tdata)
    for f in ("x", "y", "group"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype


@pytest.mark.parametrize("split", [
    lambda m, ds: m.split_by_group(ds, seed=1),
    lambda m, ds: m.split_iid(ds, 7, seed=2),
    lambda m, ds: m.split_dirichlet(ds, 5, alpha=0.3, seed=4),
])
def test_federated_splits_and_sampler_identical(split):
    ds = jdata.adult_like(n=2500, dim=10, seed=0)
    fa, fb = split(jdata, ds), split(tdata, ds)
    assert fa.n_clients == fb.n_clients
    for ca, cb in zip(fa.clients, fb.clients):
        for f in ("x_train", "y_train", "x_val", "y_val", "x_test",
                  "y_test"):
            np.testing.assert_array_equal(getattr(ca, f), getattr(cb, f))
    assert fa.batch_sizes(16, proportional=True) == \
        fb.batch_sizes(16, proportional=True)
    sa, sb = fa.make_sampler(8), fb.make_sampler(8)
    ra, rb = np.random.default_rng(9), np.random.default_rng(9)
    for m in range(fa.n_clients):
        da, db = sa(m, 3, ra), sb(m, 3, rb)
        for k in ("x", "y"):
            np.testing.assert_array_equal(da[k], db[k])


# ------------------------------ host math -----------------------------------

@pytest.mark.parametrize("eps_th", [0.5, 1.0, 4.0, 10.0])
@pytest.mark.parametrize("delta", [1e-5, 1e-4])
def test_privacy_math_bitwise(eps_th, delta):
    for k in (1, 10, 500):
        for x in (1, 8, 32):
            assert (tpriv.sigma_star(k, 1.3, x, eps_th, delta)
                    == jpriv.sigma_star(k, 1.3, x, eps_th, delta))
            s = jpriv.sigma_star(k, 1.3, x, eps_th, delta)
            assert (tpriv.epsilon_after_k(k, 1.3, x, s, delta)
                    == jpriv.epsilon_after_k(k, 1.3, x, s, delta))
    assert tpriv.rho_budget(eps_th, delta) == jpriv.rho_budget(eps_th, delta)
    assert tpriv.privacy_z(eps_th, delta) == jpriv.privacy_z(eps_th, delta)


def test_accountant_ledgers_bitwise():
    sig = [0.7, 1.1, 2.5, 0.0]
    bs = [8, 16, 32, 4]
    accs = []
    for mod in (jpriv, tpriv):
        acc = mod.PrivacyAccountant(clip_norm=1.0, delta=1e-5)
        for m, (x, s) in enumerate(zip(bs, sig)):
            acc.register_client(m, x, s)
        acc.step(3)
        acc.step(2, clients=[0, 2], q=0.5)
        worst = acc.step_many([4, 1, 2],
                              masks=np.asarray([[1, 0, 1, 0], [1, 1, 1, 0],
                                                [0, 1, 0, 0]]))
        acc.charge_at_dispatch(2, [1, 2],
                               q=mod.composed_subsampling_q(0.5, 0.4))
        pending = [acc.pending_rho(m) for m in range(len(sig))]
        acc.note_arrival([2])
        accs.append((acc, worst, acc.peek_epsilon(5, q=0.25), pending))
    (a, wa, pa, qa), (b, wb, pb, qb) = accs
    np.testing.assert_array_equal(wa, wb)
    assert pa == pb and qa == qb and a.steps == b.steps
    for m in range(len(sig)):
        assert a.rho(m) == b.rho(m) and a.epsilon(m) == b.epsilon(m)
        assert a.pending_rho(m) == b.pending_rho(m)
        assert a.landed_rho(m) == b.landed_rho(m)
        assert (a.remaining_steps(m, 4.0) == b.remaining_steps(m, 4.0))
    assert a.max_epsilon() == b.max_epsilon()


@pytest.mark.parametrize("c_th", [300.0, 1000.0, 5000.0])
@pytest.mark.parametrize("eps_th", [1.0, 4.0])
def test_design_solution_bitwise(c_th, eps_th):
    kw = dict(eta=0.3, lam=0.1, lip=0.3, alpha=0.8, xi2=0.05, dim=2 * 40 + 2,
              n_clients=16)
    sols = []
    for conv, des in ((jconv, jdesign), (tconv, tdesign)):
        prob = des.DesignProblem(
            consts=conv.ProblemConstants(**kw),
            resource=des.ResourceModel(c1=100.0, c2=1.0),
            clip_norm=1.0, batch_sizes=[32] * 15 + [16], delta=1e-4,
            eps_th=eps_th, c_th=c_th)
        sols.append((dataclasses.astuple(prob.solve()),
                     des.grid_search_reference(prob, [1, 2, 4, 8])))
    assert sols[0] == sols[1]


def test_convergence_bound_bitwise():
    kw = dict(eta=0.1, lam=0.05, lip=0.5, alpha=1.0, xi2=0.1, dim=20,
              n_clients=4)
    a, b = jconv.ProblemConstants(**kw), tconv.ProblemConstants(**kw)
    assert a.tau_max() == b.tau_max()
    for k, tau in ((10, 1), (100, 5), (1000, 10)):
        s2 = [0.1, 0.2, 0.3, 0.4]
        assert (jconv.theorem1_bound(a, k, tau, s2)
                == tconv.theorem1_bound(b, k, tau, s2))
        assert jconv.bound_b(a, tau, s2) == tconv.bound_b(b, tau, s2)
        assert (jconv.reduces_to_distributed_sgd(a, k)
                == tconv.reduces_to_distributed_sgd(b, k))


# --------------------------- trees and conversion ---------------------------

def test_flatten_order_matches_jax():
    tree = {"w": np.zeros((2, 3)), "b": np.ones(2),
            "a": {"z": np.arange(3), "c": (np.zeros(1), None, np.ones(4))},
            "s": jopt.SgdState(step=np.int32(0))}
    jl, jdef = jax.tree.flatten(tree)
    tl, tdef = ttree.tree_flatten(tree)
    assert len(jl) == len(tl)
    for x, y in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    back = ttree.tree_unflatten(tdef, tl)
    assert list(back) == sorted(tree) and back["a"]["c"][1] is None
    assert isinstance(back["s"], jopt.SgdState)


def test_tree_math_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(4, 3, 2)).astype(np.float32),
            "b": rng.normal(size=(4, 2)).astype(np.float32),
            "h": rng.normal(size=(4, 5)).astype(np.float16),
            "n": np.full((4,), 7, np.int32)}
    jt = jax.tree.map(jnp.asarray, tree)
    tt = tree_from_numpy(tree, "cpu")
    for keep in (False, True):
        want = jtree.tree_mean_over_axis0(jt, keep_dtype=keep)
        got = tree_to_numpy(ttree.tree_mean_over_axis0(tt, keep_dtype=keep))
        for k in tree:
            assert np.asarray(want[k]).dtype == got[k].dtype
            np.testing.assert_allclose(np.asarray(want[k], np.float64),
                                       got[k].astype(np.float64), rtol=1e-6)
    floats = {k: tree[k] for k in ("w", "b")}
    jf, tf = jax.tree.map(jnp.asarray, floats), tree_from_numpy(floats, "cpu")
    np.testing.assert_allclose(float(jtree.tree_sq_norm(jf)),
                               float(ttree.tree_sq_norm(tf)), rtol=1e-6)
    _eq_trees(jtree.tree_broadcast_axis0(jf, 3),
              tree_to_numpy(ttree.tree_broadcast_axis0(tf, 3)))
    _eq_trees(jtree.tree_add(jf, jf), tree_to_numpy(ttree.tree_add(tf, tf)))
    _eq_trees(jtree.tree_scale(jf, 0.5),
              tree_to_numpy(ttree.tree_scale(tf, 0.5)))


def test_tree_walks_leave_no_reference_cycle():
    """tree_flatten / tree_unflatten / tree_map / tree_leaf_paths keep no
    leaf alive once their results are dropped, with the cycle collector
    off: a self-calling closure would hold its leaves in a cycle, which on
    the card keeps a model's weights allocated until a collection."""
    import gc
    import weakref
    gc.collect()
    gc.disable()
    try:
        t = torch.zeros(3)
        ref = weakref.ref(t)
        tree = {"a": [t, (t, None)], "b": jopt.SgdState(step=t)}
        leaves, treedef = ttree.tree_flatten(tree)
        back = ttree.tree_unflatten(treedef, leaves)
        mapped = ttree.tree_map(lambda x: x + 1, tree)
        assert ttree.tree_leaf_paths(tree) == ["a/0", "a/1/0", "b/step"]
        del t, tree, leaves, treedef, back, mapped
        assert ref() is None
    finally:
        gc.enable()


def test_convert_round_trip_keeps_optimizer_state_int32():
    params = jlin.init_linear(6)
    state = jopt.sgd(0.1).init(params)
    state = state._replace(step=state.step + 5)
    np_state = jax.tree.map(np.asarray, (params, state))
    t = tree_from_numpy(np_state, "cpu")
    assert t[1].step.dtype == torch.int32 and int(t[1].step) == 5
    _eq_trees(np_state, tree_to_numpy(t))


# ------------------------------ models --------------------------------------

def test_init_linear_bit_identical():
    _eq_trees(jlin.init_linear(13, 3, seed=4),
              tree_to_numpy(tlin.init_linear(13, 3, seed=4, device="cpu")))


def test_init_linear_device_guard():
    if torch.cuda.is_available():
        pytest.skip("the guard fires only where no GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlin.init_linear(4)


@pytest.mark.parametrize("loss", ["logreg_loss", "svm_loss"])
def test_losses_grads_and_eval_match_jax(loss):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(32, 12)) * 0.3).astype(np.float32)
    y = rng.integers(0, 2, size=32).astype(np.int32)
    p_np = jax.tree.map(np.asarray, jlin.init_linear(12, seed=2))
    p_np["w"] = p_np["w"] + rng.normal(size=(12, 2)).astype(np.float32)
    p_np["b"] = rng.normal(size=2).astype(np.float32)
    batch = {"x": x, "y": y}
    jl, jg = jax.value_and_grad(getattr(jlin, loss))(
        jax.tree.map(jnp.asarray, p_np), jax.tree.map(jnp.asarray, batch))
    tg, tl = torch.func.grad_and_value(getattr(tlin, loss))(
        tree_from_numpy(p_np, "cpu"), tree_from_numpy(batch, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-6)
    for k in ("w", "b"):
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   atol=1e-6)
    je = jlin.make_eval_fn(getattr(jlin, loss), x, y)(
        jax.tree.map(jnp.asarray, p_np))
    te = tlin.make_eval_fn(getattr(tlin, loss), x, y)(
        tree_from_numpy(p_np, "cpu"))
    assert te["eval_acc"] == je["eval_acc"]
    assert te["eval_loss"] == pytest.approx(je["eval_loss"], abs=1e-6)


# ----------------------------- optimizers -----------------------------------

@pytest.mark.parametrize("make", [
    lambda m, s: m.sgd(0.3),
    lambda m, s: m.sgd(s.cosine_decay(0.5, 4, final_frac=0.1)),
    lambda m, s: m.momentum(s.linear_warmup(0.2, 2), nesterov=True),
    lambda m, s: m.adamw(s.constant(0.01), weight_decay=0.1),
])
def test_optimizer_updates_match_jax(make):
    rng = np.random.default_rng(3)
    p = {"w": rng.normal(size=(5, 2)).astype(np.float32),
         "b": rng.normal(size=2).astype(np.float32)}
    jo, to = make(jopt, jsched), make(topt, tsched)
    jp, jst = jax.tree.map(jnp.asarray, p), jo.init(jax.tree.map(jnp.asarray,
                                                                   p))
    tp, tst = tree_from_numpy(p, "cpu"), to.init(tree_from_numpy(p, "cpu"))
    for _ in range(4):
        g = {"w": rng.normal(size=(5, 2)).astype(np.float32),
             "b": rng.normal(size=2).astype(np.float32)}
        ju, jst = jo.update(jax.tree.map(jnp.asarray, g), jst, jp)
        tu, tst = to.update(tree_from_numpy(g, "cpu"), tst, tp)
        jp, tp = jtree.tree_add(jp, ju), ttree.tree_add(tp, tu)
        for a, b in zip(jax.tree.leaves((ju, jst)), ttree.tree_leaves(
                (tu, tst))):
            assert np.asarray(a).dtype == b.numpy().dtype
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    assert tst.step.dtype == torch.int32 and int(tst.step) == 4


def test_lr_is_float32_like_jax():
    """A float64 numpy lr still makes an f32 eta (JAX runs with x64 off)."""
    opt = topt.sgd(np.float64(0.1))
    p = {"w": torch.ones(3)}
    upd, _ = opt.update({"w": torch.ones(3)}, opt.init(p), p)
    assert upd["w"].dtype == torch.float32
    assert float(upd["w"][0]) == float(np.float32(-0.1))


# ---------------------------- import guard ----------------------------------

def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    scripts = sorted((ROOT / "benchmarks").glob("*_torch.py")) + sorted(
        (ROOT / "examples").glob("*_torch.py"))
    assert len(scripts) >= 16
    files += scripts
    # what the ranks of a HostWorld import in the sharded-engine tests
    files.append(ROOT / "tests" / "_torch_world_cases.py")
    assert len(files) > 10
    names = {str(f.relative_to(ROOT)) for f in files}
    for must in ("benchmarks/throughput_torch.py",
                 "benchmarks/roofline_torch.py",
                 "src/repro_torch/utils/roofline.py",
                 "src/repro_torch/utils/cost.py",
                 "src/repro_torch/configs/shapes.py",
                 "src/repro_torch/launch/env.py",
                 "src/repro_torch/launch/dryrun.py",
                 "src/repro_torch/api/federation.py",
                 "src/repro_torch/core/adaptive.py",
                 "src/repro_torch/core/fl_shard_map.py",
                 "src/repro_torch/mesh/placement.py",
                 "src/repro_torch/mesh/engine.py",
                 "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/models/sharding.py",
                 "examples/mesh_quickstart_torch.py",
                 "tests/_torch_world_cases.py"):
        assert must in names, must
    for f in files:
        bad = {m for m in _imported_roots(f)} & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
