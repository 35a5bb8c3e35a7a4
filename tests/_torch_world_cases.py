"""What the ranks of a ``repro_torch.launch.mesh.HostWorld`` run for the
sharded-engine tests (tests/test_torch_shard_map.py and friends).

Every function here is the SPMD program of one rank: it builds the spec
from plain keyword arguments (a spec's optimizer does not pickle), drives
the port's public entry points on the CPU and returns numpy, so the test
process can compare the ranks with each other and with the JAX package.
The module imports neither jax nor the JAX package: each rank starts
fresh and imports only this.
"""
import contextlib

import numpy as np
import torch

import repro_torch.api as tapi
import repro_torch.api.state as tstate
import repro_torch.core.fl as tfl
import repro_torch.population as tpop
from repro_torch.data import adult_like, split_iid
from repro_torch.models import linear as tlin
from repro_torch.optim import momentum as tmomentum
from repro_torch.optim import sgd as tsgd
from repro_torch.utils.convert import tree_to_numpy

_OPTIMIZERS = {}


def make_spec(kw: dict) -> tapi.FederationSpec:
    """``FederationSpec(**kw)`` with ``kw["opt"] = (name, lr)`` made into
    one optimizer instance per (name, lr) (round caches stay shared)."""
    kw = dict(kw)
    name, lr = kw.pop("opt", ("sgd", 0.2))
    key = (name, lr)
    if key not in _OPTIMIZERS:
        _OPTIMIZERS[key] = (tsgd if name == "sgd" else tmomentum)(lr)
    return tapi.FederationSpec(loss_fn=tlin.logreg_loss,
                               optimizer=_OPTIMIZERS[key], **kw)


def slab_cut(noise, slab):
    """The (C, tau, N) whole ``noise`` cut to ``slab``'s (block, tau,
    N_local): the block's rows (pad rows client 0's), then the model
    rank's columns by ``mesh.engine.local_noise``; whole without a slab."""
    noise = torch.as_tensor(noise)
    if slab is None:
        return noise
    from repro_torch.mesh.engine import local_noise
    from repro_torch.utils.tree import tree_flatten, tree_unflatten
    noise = slab.take(noise)
    if slab.mesh_shape[1] == 1:
        return noise
    treedef = tree_flatten(slab.param_dims)[1]
    shapes = tree_unflatten(treedef, [torch.empty(sh, device="meta")
                                      for sh in slab.shapes])
    return local_noise(noise, shapes, slab.param_dims, slab.model_index,
                       slab.mesh_shape[1])


@contextlib.contextmanager
def replayed(draws):
    """Make the drivers draw ``draws`` (one entry per round, in order):
    a (C, tau, N) noise array for a dense spec, ``(mask, noise,
    agg_rand)`` for a pipeline spec, each cut to a slab state's rows and
    columns (:func:`slab_cut`). Under a secure sum the pair masks come
    from a generator seeded alike on every rank (they cancel)."""
    if draws is None:
        yield
        return
    it = iter(draws)
    gen = torch.Generator().manual_seed(11)

    def noise_draw(key, params, tau, slab=None):
        return slab_cut(next(it), slab), key

    def pipeline_draw(key, params, tau, pipeline, slab=None):
        mask, noise, agg_rand = next(it)
        agg_rand = None if agg_rand is None else torch.as_tensor(agg_rand)
        if slab is not None and agg_rand is not None:
            agg_rand = slab.take(agg_rand)
        if pipeline.secure is not None:
            agg_rand = (agg_rand,
                        pipeline.secure.draw(gen, noise.shape[-1], "cpu"))
        return (torch.as_tensor(mask), slab_cut(noise, slab), agg_rand,
                key)

    saved = [(m, n, getattr(m, n)) for m in (tstate, tfl)
             for n in ("draw_round_noise", "draw_pipeline_round")]
    for m in (tstate, tfl):
        m.draw_round_noise = noise_draw
        m.draw_pipeline_round = pipeline_draw
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def _record(rec) -> dict:
    rec = tapi.materialize_record(rec)
    return {k: rec[k] for k in ("loss", "round", "iterations",
                                "max_epsilon", "resource_spent",
                                "participants")}


def state_numpy(state) -> dict:
    """The whole state (``whole_state``: a collective on a slab state's
    mesh) as numpy."""
    state = tapi.whole_state(state)
    return {"params": tree_to_numpy(state.params),
            "opt_state": tree_to_numpy(state.opt_state),
            "residual": (None if state.residual is None
                         else state.residual.numpy()),
            "key": state.key.numpy(), "rho": np.asarray(state.rho),
            "steps": state.steps, "resource_spent": state.resource_spent,
            "rounds_done": state.rounds_done}


def federate(kw: dict, dim: int, batches: list, draws=None,
             chunk: bool = False) -> dict:
    """len(batches) rounds of ``make_spec(kw)`` from ``init_linear(dim)``:
    one ``run_round`` each, or one ``run_rounds`` chunk with ``chunk``.
    Returns the final state and the records as numpy."""
    spec = make_spec(kw)
    state = tapi.init_state(spec, tlin.init_linear(dim, device="cpu"),
                            device="cpu")
    with replayed(draws):
        if chunk:
            stacked = {k: np.stack([b[k] for b in batches]) for k in
                       batches[0]}
            state, recs = tapi.run_rounds(spec, state, stacked,
                                          check_budgets=False)
        else:
            recs = []
            for batch in batches:
                state, rec = tapi.run_round(spec, state, batch,
                                            check_budgets=False)
                recs.append(rec)
    return {"state": state_numpy(state), "records": [_record(r)
                                                     for r in recs]}


def train_to_budget(kw: dict, dim: int, max_rounds: int,
                    chunk_rounds: int = 1) -> dict:
    """``train`` until a budget binds, on Adult-like data split IID."""
    spec = make_spec(kw)
    fed = split_iid(adult_like(n=60 * spec.n_clients, dim=dim, seed=0),
                    spec.n_clients)
    state = tapi.init_state(spec, tlin.init_linear(dim, device="cpu"),
                            device="cpu")
    state, out = tapi.train(spec, state, fed.make_sampler(
        spec.batch_sizes[0]), max_rounds=max_rounds,
        chunk_rounds=chunk_rounds)
    return {"state": state_numpy(state), "rounds": out["rounds"],
            "max_epsilon": out["max_epsilon"],
            "resource_spent": out["resource_spent"],
            "losses": [float(r["loss"]) for r in out["history"]]}


def _slab_record(state) -> dict:
    """A slab state's layout and what each rank holds: the shapes of its
    params, optimizer state and residual leaves and their bytes."""
    from repro_torch.utils.tree import tree_leaves
    lay = state.layout
    trees = (state.params, state.opt_state, state.residual)
    return {"mesh_shape": lay.mesh_shape, "block": lay.block,
            "rows": lay.n_rows, "idle": lay.idle,
            "client_index": lay.client_index,
            "model_index": lay.model_index,
            "shapes": [[tuple(x.shape) for x in tree_leaves(t)]
                       for t in trees],
            "bytes": sum(x.numel() * x.element_size()
                         for t in trees for x in tree_leaves(t))}


def fresh_state(spec, p0, slab: bool = True):
    """``init_state(spec, p0)`` on the CPU: slab state where it applies,
    or (``slab=False``) that state made whole (``whole_state``: the whole
    layout, which runs the whole-tree round)."""
    st = tapi.init_state(spec, p0, device="cpu")
    return st if slab else tapi.whole_state(st)


def _stacked(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def slab_and_whole(kw: dict, dim: int, batches: list) -> dict:
    """``make_spec(kw)`` (a sharded engine) from ``init_linear(dim)`` in
    slab state and in the whole layout (:func:`fresh_state`
    ``slab=False``: the whole-tree round) on this rank: one ``run_round``
    a batch and one ``run_rounds`` chunk of them each, then
    ``eval_params``. Returns the states made
    whole (numpy), the records, the eval models and the slab's layout."""
    spec = make_spec(kw)
    p0 = tlin.init_linear(dim, device="cpu")
    out = {}
    for form, slab in (("slab", True), ("whole", False)):
        st = fresh_state(spec, p0, slab)
        assert (st.layout is None) == (form == "whole")
        if form == "slab":
            out["layout"] = _slab_record(st)
        recs = []
        for batch in batches:
            st, rec = tapi.run_round(spec, st, batch, check_budgets=False)
            recs.append(_record(rec))
        if form == "slab":
            out["layout_after"] = _slab_record(st)
        out[form] = {"state": state_numpy(st), "records": recs,
                     "eval": tree_to_numpy(tapi.eval_params(spec, st))}
        st = fresh_state(spec, p0, slab)
        st, recs = tapi.run_rounds(spec, st, _stacked(batches),
                                   check_budgets=False)
        out[form + "_chunk"] = {"state": state_numpy(st),
                                "records": [_record(r) for r in recs]}
    return out


def slab_block_batches(kw: dict, dim: int, batches: list) -> dict:
    """``make_spec(kw)`` (mesh_2d) in slab state on this rank, fed once the
    whole (C, ...) batches and once only its block's rows of them (pad
    rows: client 0's), per round (``run_round``) and as one chunk
    (``run_rounds``). Returns the four states made whole (numpy)."""
    spec = make_spec(kw)
    p0 = tlin.init_linear(dim, device="cpu")
    lay = fresh_state(spec, p0).layout
    out = {}
    for form, part in (("whole", batches),
                       ("block", [lay.take(b) for b in batches])):
        st = fresh_state(spec, p0)
        for batch in part:
            st, _ = tapi.run_round(spec, st, batch, check_budgets=False)
        out[form] = state_numpy(st)
        st, _ = tapi.run_rounds(spec, fresh_state(spec, p0), _stacked(part),
                                check_budgets=False)
        out[form + "_chunk"] = state_numpy(st)
    return out


def slab_train(kw: dict, dim: int, max_rounds: int, chunk_rounds: int,
               slab: bool = True) -> dict:
    """``train`` until a budget binds (chunks of ``chunk_rounds``, an eval
    every round on a fixed batch through ``eval_params``) on Adult-like
    data split IID, in slab state or (``slab=False``) the whole layout."""
    spec = make_spec(kw)
    fed = split_iid(adult_like(n=60 * spec.n_clients, dim=dim, seed=0),
                    spec.n_clients)
    ev = fed.make_sampler(16)(0, 1, np.random.default_rng(5))
    ev = {k: torch.as_tensor(v[0]) for k, v in ev.items()}
    evals = []

    def eval_fn(params):
        evals.append(tree_to_numpy(params))
        return {"eval_loss": float(tlin.logreg_loss(params, ev))}

    state = fresh_state(spec, tlin.init_linear(dim, device="cpu"), slab)
    state, out = tapi.train(spec, state, fed.make_sampler(
        spec.batch_sizes[0]), max_rounds=max_rounds,
        chunk_rounds=chunk_rounds, eval_fn=eval_fn)
    return {"state": state_numpy(state), "rounds": out["rounds"],
            "max_epsilon": out["max_epsilon"],
            "resource_spent": out["resource_spent"],
            "losses": [float(r["loss"]) for r in out["history"]],
            "eval_losses": [r.get("eval_loss") for r in out["history"]],
            "evals": evals, "best_round": out["best"]["round"]}


def slab_checkpoint(kw: dict, dim: int, batches: list, directory: str,
                    r1: int) -> dict:
    """Checkpoints across layouts: the first ``r1`` of ``batches`` in one
    layout, ``save_state`` into ``directory/<layout>``, the rest on, and the
    checkpoint loaded into a fresh state of each layout (slab, the whole
    mesh_2d layout, ``vmap``) that runs the rest. Returns each state made
    whole (numpy): "<writer>@save", "<writer>" (uninterrupted),
    "<writer>><reader>@load" and "<writer>><reader>"."""
    import os
    spec = make_spec(kw)
    vspec = make_spec(dict(kw, engine="vmap", mesh_shape=None))
    p0 = tlin.init_linear(dim, device="cpu")
    layouts = {"slab": (spec, True), "whole": (spec, False),
               "vmap": (vspec, True)}

    def drive(sp, st, part):
        for batch in part:
            st, _ = tapi.run_round(sp, st, batch, check_budgets=False)
        return st

    out = {}
    for writer in ("slab", "vmap"):
        sp, slab = layouts[writer]
        path = os.path.join(directory, writer)
        st = drive(sp, fresh_state(sp, p0, slab), batches[:r1])
        tapi.save_state(path, st)
        out[f"{writer}@save"] = state_numpy(st)
        out[writer] = state_numpy(drive(sp, st, batches[r1:]))
        for reader, (rsp, rslab) in layouts.items():
            like = fresh_state(rsp, p0, rslab)
            st, _ = tapi.load_state(path, like)
            assert (st.layout is None) == (reader != "slab")
            out[f"{writer}>{reader}@load"] = state_numpy(st)
            out[f"{writer}>{reader}"] = state_numpy(
                drive(rsp, st, batches[r1:]))
    return out


def transformer_slab_round(cfg, params0, batch, noise, kw: dict) -> dict:
    """One DP round of the transformer ``cfg`` from ``params0`` (numpy,
    one client's tree) on ``batch`` under ``kw``'s mesh_2d spec in slab
    state, through ``run_round`` with the (C, tau, N) ``noise`` replayed
    (cut to the slab): the params made whole, the loss and the slab's
    layout."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.utils.convert import tree_from_numpy
    model = Transformer(cfg)
    spec = tapi.FederationSpec(loss_fn=model.loss_fn, optimizer=tsgd(0.05),
                               **kw)
    state = tapi.init_state(spec, tree_from_numpy(params0, "cpu"),
                            device="cpu")
    layout = _slab_record(state)
    with replayed([noise]):
        state, rec = tapi.run_round(spec, state, batch, check_budgets=False)
    return {"params": tree_to_numpy(tapi.whole_state(state).params),
            "loss": float(rec["loss"]), "layout": layout}


def cohort_and_dense(kw: dict, dim: int, rounds: int,
                     layout: bool = False) -> dict:
    """The cohort path at M == C and the dense participation path, both
    under ``kw``'s engine: states and records of each (with ``layout``,
    also the cohort state's slab layout)."""
    dense = make_spec(kw)
    pspec = make_spec(dict(kw, population=dense.n_clients,
                           cohort_size=dense.n_clients))
    fed = split_iid(adult_like(n=100 * dense.n_clients, dim=dim, seed=0),
                    dense.n_clients)
    pop = tpop.population_from_federated(fed, dense.batch_sizes[0])
    s_d = tapi.init_state(dense, tlin.init_linear(dim, device="cpu"),
                          device="cpu")
    s_p = tpop.init_population_state(
        pspec, tlin.init_linear(dim, device="cpu"), device="cpu")
    rng_d, rng_p = np.random.default_rng(0), np.random.default_rng(0)
    sampler = fed.make_sampler(dense.batch_sizes[0])
    rec_d, rec_p = [], []
    for _ in range(rounds):
        s_d, r = tapi.run_round(dense, s_d, tapi.round_batch(
            dense, sampler, rng_d), check_budgets=False)
        rec_d.append(_record(r))
        s_p, r = tpop.run_cohort_round(pspec, s_p, pop, rng_p,
                                       check_budgets=False)
        rec_p.append(_record(r))
    residual = (None if s_d.residual is None else
                s_p.store.gather_residual(np.arange(dense.n_clients)))
    if layout:
        layout = _slab_record(s_p.fl)
    return {"dense": state_numpy(s_d), "dense_records": rec_d,
            **({"layout": layout} if layout else {}),
            "cohort": state_numpy(s_p.fl), "cohort_records": rec_p,
            "cohort_rho": np.asarray(s_p.store.rho),
            "cohort_residual": residual}


def resident_and_per_round(kw: dict, dim: int, population: int,
                           rounds: int, chunk: int) -> dict:
    """A population of ``population`` under ``kw``'s engine, driven per
    round and through the resident cohort cache (every virtual client
    resident): both final states."""
    spec = make_spec(dict(kw, population=population,
                          cohort_size=kw["n_clients"]))
    pop = tpop.synthetic_population(population, dim,
                                    batch_size=spec.batch_sizes[0], seed=0)
    out = {}
    for mode in ("per_round", "resident"):
        st = tpop.init_population_state(
            spec, tlin.init_linear(dim, device="cpu"), device="cpu")
        rng = np.random.default_rng(0)
        losses = []
        if mode == "per_round":
            for _ in range(rounds):
                st, rec = tpop.run_cohort_round(spec, st, pop, rng,
                                                check_budgets=False)
                losses.append(float(rec["loss"]))
        else:
            cache = tpop.init_resident_cache(spec, st, population,
                                             population=pop)
            for _ in range(rounds // chunk):
                st, recs = tpop.run_resident_rounds(
                    spec, st, pop, rng, cache, n_rounds=chunk,
                    check_budgets=False)
                losses.extend(float(r["loss"]) for r in recs)
            cache.flush(st.store)
        out[mode] = {"state": state_numpy(st.fl), "losses": losses,
                     "store_rho": np.asarray(st.store.rho)}
    return out


def slab_round_traffic(kw: dict, dim: int, batch: dict) -> dict:
    """One ``run_round`` of ``make_spec(kw)`` in slab state on this rank,
    recording every ``torch.distributed`` collective it makes (name, and
    for an all-reduce the dtype and element count) and every counter
    generator draw (purpose and row ids); plus the slab's layout."""
    import torch.distributed as dist

    import repro_torch.core.aggregation as tagg
    spec = make_spec(kw)
    state = fresh_state(spec, tlin.init_linear(dim, device="cpu"))
    tapi.run_round(spec, state, batch, check_budgets=False)  # build, warm
    calls, draws = [], []
    names = ("all_reduce", "broadcast", "broadcast_object_list",
             "all_gather", "all_gather_into_tensor", "reduce_scatter",
             "reduce_scatter_tensor", "gather", "scatter", "send", "recv")
    saved = {n: getattr(dist, n) for n in names}
    draw_saved = (tfl.counter_draw, tagg.counter_draw)

    def spy(name):
        def call(*args, **kwargs):
            t = args[0] if args else None
            calls.append((name, str(t.dtype), t.numel())
                         if isinstance(t, torch.Tensor) else (name,))
            return saved[name](*args, **kwargs)
        return call

    def drawn(real):
        def call(key, rows, table, tau, n, purpose, normal, device):
            draws.append((int(purpose), tuple(rows)))
            return real(key, rows, table, tau, n, purpose, normal, device)
        return call

    for n in names:
        setattr(dist, n, spy(n))
    tfl.counter_draw, tagg.counter_draw = (drawn(f) for f in draw_saved)
    try:
        tapi.run_round(spec, state, batch, check_budgets=False)
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)
        tfl.counter_draw, tagg.counter_draw = draw_saved
    return {"calls": calls, "draws": draws, "layout": _slab_record(state),
            "rows": state.layout.rows}


def store_numpy(store) -> dict:
    """A ClientStore's ledger and every virtual client's residual row."""
    vids = np.arange(store.population)
    return {"rho": np.asarray(store.rho),
            "rounds_participated": np.asarray(store.rounds_participated),
            "residual": (store.gather_residual(vids)
                         if store.needs_residual() else None),
            "residual_rows": (store.residual_rows()
                              if store.needs_residual() else None)}


def population_forms(kw: dict, dim: int, population: int, per_round: int,
                     chunk: int, chunks: int, capacity: int,
                     stationary: bool, draws=None, seed: int = 2) -> dict:
    """A population of ``population`` (``synthetic_population``, shards
    stationary or streaming) under ``kw``'s engine with cohorts of
    ``kw["n_clients"]``, in slab state and in the whole layout (the slab
    state made whole): ``per_round`` ``run_cohort_round`` calls, one
    ``run_cohort_rounds`` chunk of ``chunk``, then ``chunks`` resident
    chunks of ``chunk`` through a cache of ``capacity`` slots, flushed.
    ``draws`` (JAX's, in round order) are replayed when given. Returns
    each form's state made whole, store, records and cache stats, and
    the slab's layout before and after."""
    spec = make_spec(dict(kw, population=population,
                          cohort_size=kw["n_clients"]))
    pop = tpop.synthetic_population(population, dim,
                                    batch_size=spec.batch_sizes[0],
                                    seed=seed, stationary=stationary)
    out = {}
    for form in ("slab", "whole"):
        with replayed(draws):
            st = tpop.init_population_state(
                spec, tlin.init_linear(dim, device="cpu"), device="cpu")
            if form == "slab":
                out["layout"] = _slab_record(st.fl)
            else:
                st = st.replace(fl=tapi.whole_state(st.fl))
            rng = np.random.default_rng(0)
            recs = []
            for _ in range(per_round):
                st, rec = tpop.run_cohort_round(spec, st, pop, rng,
                                                check_budgets=False)
                recs.append(_record(rec))
            st, rs = tpop.run_cohort_rounds(spec, st, pop, rng,
                                            n_rounds=chunk,
                                            check_budgets=False)
            recs += [_record(r) for r in rs]
            cache = tpop.init_resident_cache(spec, st, capacity,
                                             population=pop)
            for _ in range(chunks):
                st, rs = tpop.run_resident_rounds(spec, st, pop, rng, cache,
                                                  n_rounds=chunk,
                                                  check_budgets=False)
                recs += [_record(r) for r in rs]
            if form == "slab":
                out["layout_after"] = _slab_record(st.fl)
            cache.flush(st.store)
        out[form] = {"state": state_numpy(st.fl), "records": recs,
                     "store": store_numpy(st.store),
                     "stats": dict(cache.stats),
                     "vids": np.asarray(cache.vids)}
    return out


def population_checkpoint(kw: dict, dim: int, population: int,
                          rounds: int, directory: str) -> dict:
    """``rounds`` cohort rounds of a population of ``population`` under
    ``kw``'s engine in slab state, saved with ``save_population_state``
    to ``directory`` and loaded into a fresh slab state and into the
    whole layout; then one more round from each of the three. Returns
    the saved state made whole and store, each loaded form's, the loaded
    slab's layout and the three next rounds'."""
    spec = make_spec(dict(kw, population=population,
                          cohort_size=kw["n_clients"]))
    pop = tpop.synthetic_population(population, dim,
                                    batch_size=spec.batch_sizes[0], seed=2)

    def fresh(slab: bool):
        st = tpop.init_population_state(
            spec, tlin.init_linear(dim, device="cpu"), device="cpu")
        return st if slab else st.replace(fl=tapi.whole_state(st.fl))

    def record(st):
        return {"state": state_numpy(st.fl), "store": store_numpy(st.store)}

    st, rng = fresh(True), np.random.default_rng(0)
    for _ in range(rounds):
        st, _ = tpop.run_cohort_round(spec, st, pop, rng,
                                      check_budgets=False)
    tpop.save_population_state(directory, st, extra={"tag": 7})
    out = {"saved": record(st)}
    forms = {"saved": st}
    for form in ("slab", "whole"):
        loaded, extra = tpop.load_population_state(
            directory, fresh(form == "slab"))
        assert extra["tag"] == 7
        forms[form] = loaded
        out[form] = record(loaded)
    out["layout"] = _slab_record(forms["slab"].fl)
    out["next"] = {}
    for form, st in forms.items():
        st, _ = tpop.run_cohort_round(spec, st, pop,
                                      np.random.default_rng(1),
                                      check_budgets=False)
        out["next"][form] = record(st)
    return out


def mesh_views() -> dict:
    """The meshes of :mod:`repro_torch.launch.mesh` seen from this rank of
    a world of 4, the refusals, and a (2, 2) mesh_2d round's build."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as lmesh

    def ranks(mesh, axis):
        return dist.get_process_group_ranks(mesh.get_group(axis))

    m22 = lmesh.make_mesh_2d((2, 2))
    m41 = lmesh.make_mesh_2d((4, 1))
    m31 = lmesh.make_mesh_2d((3, 1))
    fed = lmesh.make_federated_mesh(m22, 2)
    serve = lmesh.make_serving_mesh(fed)
    out = {
        "m22": (tuple(m22.shape), m22.mesh_dim_names, m22.get_coordinate(),
                ranks(m22, "client"), ranks(m22, "model")),
        "m41": (tuple(m41.shape), m41.get_coordinate(),
                ranks(m41, "client")),
        "m31": m31.get_coordinate(),
        "fed": (tuple(fed.shape), fed.mesh_dim_names,
                fed.mesh.tolist()),
        "serve": (tuple(serve.shape), serve.mesh_dim_names,
                  serve.mesh.tolist()),
        "n_clients": (lmesh.default_n_clients(m22),
                      lmesh.default_n_clients(m22, 6)),
        "same_mesh": lmesh.make_mesh_2d((2, 2)) is m22,
        "world": lmesh.world_size(),
    }
    for name, call in (
            ("too_big", lambda: lmesh.make_mesh_2d((3, 2))),
            ("production", lambda: lmesh.make_production_mesh()),
            ("multi_pod", lambda: lmesh.make_production_mesh(
                multi_pod=True)),
            ("model_axis", lambda: tapi.round_fn_for(make_spec(dict(
                n_clients=4, tau=1, sigmas=(0.5,) * 4, engine="mesh_2d",
                mesh_shape=(2, 2)))))):
        try:
            call()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


# ------------------------- the model axis (dm > 1) ---------------------------

@contextlib.contextmanager
def device_budget(budget: int):
    """The device budget ``REPRO_DEVICE_MEM_BYTES`` set to ``budget`` on
    this rank while the block runs."""
    import os

    from repro_torch.mesh.placement import ENV_DEVICE_MEM
    os.environ[ENV_DEVICE_MEM] = str(budget)
    try:
        yield
    finally:
        del os.environ[ENV_DEVICE_MEM]


def federate_on_budget(kw: dict, dim: int, batches: list, draws, budget):
    """:func:`federate` under :func:`device_budget` ``budget``; also the
    engine and mesh shape an ``engine="auto"`` spec resolves to."""
    from repro_torch.api.engines import mesh_shape_for
    with device_budget(budget):
        spec = make_spec(kw)
        engine = tapi.resolve_engine(spec)
        shape = mesh_shape_for(spec) if engine == "mesh_2d" else None
        out = federate(kw, dim, batches, draws)
    return dict(out, engine=engine, mesh_shape=shape)


def _mesh_group(shape):
    from repro_torch.launch import mesh as lmesh
    from repro_torch.mesh.collectives import ModelGroup
    mesh = lmesh.make_mesh_2d(shape)
    return mesh, ModelGroup(mesh)


def tp_layers(shape, seed: int) -> dict:
    """The MLP and attention with their weights split over the model axis
    of a ``shape`` mesh (this rank's slices, under the model context),
    against the same layers whole on this rank: each layer's output and
    its gradients (w.r.t. every weight, and the input) under
    ``vmap(grad_and_value)`` and under the ``map`` engine's loop over
    clients (no vmap). Returns each quantity's largest gap divided by its
    largest magnitude."""
    from torch.func import grad, grad_and_value, vmap

    from repro_torch.models import attention, layers, sharding
    mesh, grp = _mesh_group(shape)
    rng = np.random.default_rng(seed)
    c, b, s, d, f, h, kv, hd = 3, 2, 12, 16, 24, 4, 2, 8

    def normal(*sh):
        return torch.as_tensor(rng.standard_normal(sh).astype(np.float32))

    mlp_p = {"w_gate": normal(c, d, f) / 4, "w_up": normal(c, d, f) / 4,
             "w_down": normal(c, f, d) / 5}
    att_p = {"wq": normal(c, d, h, hd) / 4, "wk": normal(c, d, kv, hd) / 4,
             "wv": normal(c, d, kv, hd) / 4, "wo": normal(c, h, hd, d) / 5,
             "bq": normal(c, h, hd) / 10, "bk": normal(c, kv, hd) / 10,
             "bv": normal(c, kv, hd) / 10}
    x = normal(c, b, s, d)
    pos = torch.arange(s)
    layers_ = {
        "mlp": (mlp_p, lambda p, x: layers.mlp(p, x)),
        "attention_swa": (att_p, lambda p, x: attention
                          .attention_forward_train(p, x, pos, kind="swa",
                                                   window=5, block_q=4)),
        "attention_full": (att_p, lambda p, x: attention
                           .attention_forward_train(p, x, pos, block_q=4))}
    out = {}
    for name, (params, layer) in layers_.items():
        def loss(p, x, layer=layer):
            y = layer(p, x)
            return torch.sum(y * torch.sin(y))

        dims = sharding.param_split_dims(
            {k: v[0] for k, v in params.items()}, grp.size)
        local = sharding.to_local(params, dims, grp.index, grp.size, lead=1)
        g_w, l_w = vmap(grad_and_value(loss))(params, x)
        gx_w = vmap(grad(loss, argnums=1))(params, x)
        with sharding.axis_rules(mesh, sharding.mesh2d_rules()):
            g_s, l_s = vmap(grad_and_value(loss))(local, x)
            gx_s = vmap(grad(loss, argnums=1))(local, x)
            loop = [grad_and_value(loss)({k: v[i] for k, v in local.items()},
                                         x[i]) for i in range(c)]
        g_s = sharding.to_whole(g_s, dims, grp, lead=1)
        g_m = sharding.to_whole({k: torch.stack([g[0][k] for g in loop])
                                 for k in local}, dims, grp, lead=1)
        l_m = torch.stack([g[1] for g in loop])

        def rel(a, w):
            return float(torch.max(torch.abs(a - w))
                         / torch.clamp(torch.max(torch.abs(w)), min=1e-30))

        out[name] = {
            "dims": dims,
            "loss_vmap": rel(l_s, l_w), "loss_map": rel(l_m, l_w),
            "input_grad": rel(gx_s, gx_w),
            **{f"grad_{k}_vmap": rel(g_s[k], g_w[k]) for k in params},
            **{f"grad_{k}_map": rel(g_m[k], g_w[k]) for k in params}}
    return out


def split_clip(shape, seed: int) -> dict:
    """A (R, ...) gradient tree, some leaves split over the model axis of a
    ``shape`` mesh and some whole, clipped and noised by the split form
    (``row_sumsq`` -> all-reduce -> ``clip_noise_apply``) on this rank's
    slices, with and without noise: the result made whole again (in tree
    order, one (R, N) block) and the norms."""
    from repro_torch.kernels import ops
    from repro_torch.mesh.engine import local_noise
    from repro_torch.models import sharding
    from repro_torch.utils.tree import tree_flatten
    mesh, grp = _mesh_group(shape)
    rng = np.random.default_rng(seed)
    r = 5
    tree = {"a": rng.standard_normal((r, 6, 4)), "b": rng.standard_normal(
        (r, 3)), "c": rng.standard_normal((r, 2, 8, 3)),
        "d": rng.standard_normal((r, 7))}
    # rows over and under the clip norm
    scale = np.array([0.05, 0.1, 1.0, 3.0, 10.0]) / 3
    tree = {k: torch.as_tensor((v * scale.reshape((r,) + (1,) * (v.ndim - 1))
                                ).astype(np.float32))
            for k, v in tree.items()}
    dims = {"a": 1, "b": -1, "c": 1, "d": -1}
    n = sum(x[0].numel() for x in tree.values())
    noise = torch.as_tensor(rng.standard_normal((r, n)).astype(np.float32))
    sigma = torch.as_tensor(np.linspace(0.1, 0.9, r).astype(np.float32))
    local_nz = local_noise(noise, {k: v[0] for k, v in tree.items()}, dims,
                           grp.index, grp.size)
    local = sharding.to_local(tree, dims, grp.index, grp.size, lead=1)
    flat_dims = tree_flatten(dims)[0]
    out = {}
    for name, nz in (("noise", noise), ("clip_only", None)):
        got, norm = ops.dp_clip_noise_split_tree(
            local, None if nz is None else local_nz, 1.5,
            sigma, flat_dims, grp)
        whole = sharding.to_whole(got, dims, grp, lead=1)
        out[name] = (torch.cat([x.reshape(r, -1) for x in
                                tree_flatten(whole)[0]], 1).numpy(),
                     norm.numpy())
    out["inputs"] = (torch.cat([x.reshape(r, -1) for x in
                                tree_flatten(tree)[0]], 1).numpy(),
                     noise.numpy(), sigma.numpy())
    return out


def transformer_round(cfg, params0, batch, noise, sigmas, kw: dict) -> dict:
    """One DP round of the transformer ``cfg`` from ``params0`` (numpy, one
    client's tree in the port's layout) on ``batch`` with the (C, tau, N) ``noise`` under
    ``kw``'s spec (its engine and mesh shape), through the engine's round
    function; plus, under a model axis, the first step's per-client loss
    gradients (made whole) and the Eq.-7a clip's pre-clip norms, and the
    engine (and mesh shape) the spec resolves to. Returns numpy."""
    from torch.func import grad_and_value, vmap

    from repro_torch.core.clipping import make_dp_grad_fn
    from repro_torch.kernels.ops import flatten_rows
    from repro_torch.mesh.engine import local_noise
    from repro_torch.models import sharding
    from repro_torch.models.transformer import Transformer
    from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy
    from repro_torch.utils.tree import tree_flatten, tree_map
    model = Transformer(cfg)
    spec = tapi.FederationSpec(loss_fn=model.loss_fn, optimizer=tsgd(0.05),
                               **kw)
    p0 = tree_from_numpy(params0, "cpu")
    state = tapi.init_state(spec, p0, device="cpu")
    tb = tree_from_numpy(batch, "cpu")
    sig = torch.as_tensor(np.asarray(sigmas, np.float32))
    state = tapi.whole_state(state)
    tp, _, ms = tapi.round_fn_for(spec)(state.params, state.opt_state, tb,
                                        torch.as_tensor(noise), sig)
    out = {"params": tree_to_numpy(tp), "loss": float(ms["loss"]),
           "grad_norm_preclip": float(ms["grad_norm_preclip"]),
           "engine": tapi.resolve_engine(spec)}
    if out["engine"] != "mesh_2d":
        return out
    from repro_torch.api.engines import mesh_shape_for
    shape = out["mesh_shape"] = mesh_shape_for(spec)
    if shape[1] == 1:
        return out
    mesh, grp = _mesh_group(shape)
    if grp.index is None:               # a rank outside the mesh
        return out
    step0 = tree_map(lambda x: x[:, 0], tb)
    one = p0
    dims = sharding.param_split_dims(one, grp.size)
    local = sharding.to_local(state.params, dims, grp.index, grp.size,
                              lead=1)
    dp_grad = make_dp_grad_fn(model.loss_fn, spec.clip_norm)
    with sharding.axis_rules(mesh, sharding.mesh2d_rules(), placement=dims):
        g, loss = vmap(grad_and_value(model.loss_fn))(local, step0)
        _, metrics = dp_grad(local, step0, local_noise(
            torch.as_tensor(noise[:, 0]), one, dims, grp.index, grp.size),
            sig)
    whole = sharding.to_whole(g, dims, grp, lead=1)
    out.update(grads=tree_to_numpy(whole), step_loss=loss.numpy(),
               step_norm=metrics["grad_norm_preclip"].numpy(),
               flat_grads=flatten_rows(tree_flatten(whole)[0]).numpy())
    return out


def transformer_round_on_budget(budget: int, *args) -> dict:
    """:func:`transformer_round` under :func:`device_budget` ``budget``."""
    with device_budget(budget):
        return transformer_round(*args)


def rank_one_fails() -> int:
    """Rank 1 raises at once; every other rank enters an all-reduce that
    rank 1 never joins (it would wait for the world's timeout)."""
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
    return dist.get_rank()


# ------------------------------ the serving mesh -----------------------------

@contextlib.contextmanager
def _serving(cfg, params_np, mesh_shape, shard_seq=False, fsdp=None):
    """On the serving mesh ``mesh_shape`` (``shard_seq``: a long context's
    rules; ``fsdp``: ``serve_on_mesh``'s ``fsdp_over_data``) for the
    block: the model and this rank's slices of the whole ``params_np``
    (``None`` on a rank outside the mesh)."""
    from repro_torch.launch.serve import serve_on_mesh
    from repro_torch.models import sharding
    from repro_torch.models.transformer import Transformer
    from repro_torch.utils.convert import tree_from_numpy
    model = Transformer(cfg)
    with serve_on_mesh(model, mesh_shape, shard_seq=shard_seq,
                       fsdp_over_data=fsdp) as mesh:
        local = None
        if mesh.get_coordinate() is not None:
            local = sharding.local_params(tree_from_numpy(params_np, "cpu"))
        yield model, local


def _copied(tree):
    """Every leaf of a numpy tree copied (the caches' whole leaves share
    storage with tensors the decode steps write in place)."""
    from repro_torch.utils.tree import tree_map
    return tree_map(np.array, tree)


def serve_mesh_route(cfg, params_np, prompts, forced, mesh_shape,
                     shard_seq=False, fsdp=None) -> dict:
    """The static serving route on the serving mesh ``mesh_shape``
    (``shard_seq``: a long context's rules; ``fsdp``: weights over "data"
    too): the prefill's last logits and its caches (each leaf made whole
    along its split dims over their groups), the logits of
    ``len(forced[0])`` decode steps teacher-forced with ``forced`` (B, G),
    the decode caches made whole, and ``generate``'s greedy tokens and
    logits; the bytes of the rank's params and caches. Returns numpy
    (``None`` on a rank outside the mesh)."""
    from repro_torch.launch import serve
    from repro_torch.mesh.collectives import counts
    from repro_torch.models import sharding
    from repro_torch.utils.convert import tree_to_numpy
    from repro_torch.utils.tree import tree_flatten
    with _serving(cfg, params_np, mesh_shape, shard_seq, fsdp) as (model,
                                                                   local):
        if local is None:
            return None
        prompts = torch.as_tensor(prompts)
        forced = torch.as_tensor(forced)
        b, s = prompts.shape
        g = forced.shape[1]
        axes, dims = model.cache_axes(), model.cache_dims(b, s + g)
        out = {"cache_bytes": sum(
            x.numel() * x.element_size() for x in tree_flatten(
                model.init_cache(b, s + g, "meta"))[0]),
            "param_bytes": sum(x.numel() * x.element_size()
                               for x in tree_flatten(local)[0])}
        with torch.inference_mode():
            logits, caches, pos = model.prefill(local, prompts,
                                                max_len=s + g)
            out["prefill_logits"] = logits.numpy()
            out["prefill_caches"] = _copied(tree_to_numpy(
                sharding.caches_to_whole(caches, axes, dims)))
            steps = []
            counts.update(all_reduce=0, gather=0)
            for i in range(g):
                logits, caches = model.decode_step(local, caches,
                                                   forced[:, i], pos + i)
                steps.append(logits.numpy())
            out["collectives_per_step"] = {k: v / g
                                           for k, v in counts.items()}
            out["decode_logits"] = np.stack(steps, 1)
            out["decode_caches"] = _copied(tree_to_numpy(
                sharding.caches_to_whole(caches, axes, dims)))
        tokens, seen = serve.generate(model, local, prompts, g,
                                      with_logits=True)
        out["tokens"], out["token_logits"] = tokens.numpy(), seen.numpy()
        return out


def serve_mesh_generate(cfg, params_np, prompts, gen, mesh_shape,
                        temperature=0.0) -> dict:
    """``generate`` on the serving mesh ``mesh_shape`` (its data axis
    splitting the rows): the tokens and the logits they came from, and
    the rows this rank ran; ``None`` on a rank outside the mesh."""
    from repro_torch.launch import serve
    with _serving(cfg, params_np, mesh_shape) as (model, local):
        if local is None:
            return None
        gen_t = torch.Generator().manual_seed(3)
        tokens, seen = serve.generate(model, local, torch.as_tensor(prompts),
                                      gen, temperature=temperature,
                                      generator=gen_t, with_logits=True)
        return {"tokens": tokens.numpy(), "logits": seen.numpy()}


def serve_mesh_refusals(cfg, params_np) -> dict:
    """What the serving mesh refuses on this rank of a world of 4: a batch
    the data axis does not split, the engine on a data axis over 1 (both
    on a (2, 2) mesh), and a model axis of 4 (whose messages name the
    refusal)."""
    from repro_torch.launch import serve
    from repro_torch.serve import SlotEngine
    out = {}
    with _serving(cfg, params_np, (2, 2)) as (model, local):
        for name, call in (
                ("rows", lambda: serve.generate(
                    model, local, torch.zeros((3, 4), dtype=torch.int64),
                    2)),
                ("engine", lambda: SlotEngine(model, local, n_slots=2,
                                              max_len=8, device="cpu"))):
            try:
                call()
                out[name] = None
            except (ValueError, NotImplementedError) as e:
                out[name] = (type(e).__name__, str(e))
    return out


def serve_mesh_paged(cfg, params_np, prompts, lengths, forced, block_size,
                     mesh_shape) -> dict:
    """The engine's paged route on the serving mesh: ``prefill_at`` of
    right-padded ``prompts`` with their ``lengths``, ``insert_prefill``
    into block pools through a shuffled block table, then
    ``len(forced[0])`` teacher-forced ``decode_step(table=)`` steps.
    Returns the prefill's logits, the pools after the insert (made whole
    along their heads), each step's logits and the pools after the steps;
    ``None`` on a rank outside the mesh."""
    from repro_torch.models import sharding
    from repro_torch.utils.convert import tree_to_numpy
    with _serving(cfg, params_np, mesh_shape) as (model, local):
        if local is None:
            return None
        grp = sharding.model_group()
        dims = sharding.cache_split_dims(model.cache_axes(paged=True))
        return _paged_route(model, local, prompts, lengths, forced,
                            block_size, lambda t: _copied(tree_to_numpy(
                                sharding.to_whole(t, dims, grp))))


def _paged_route(model, params, prompts, lengths, forced, block_size,
                 whole):
    """:func:`serve_mesh_paged`'s calls on ``params`` (``whole`` makes a
    pool tree whole numpy)."""
    prompts = torch.as_tensor(prompts)
    lengths = torch.as_tensor(lengths)
    forced = torch.as_tensor(forced)
    b, s = prompts.shape
    g = forced.shape[1]
    bps = -(-(s + g) // block_size)
    table = torch.as_tensor(np.random.default_rng(5).permutation(
        b * bps).reshape(b, bps))
    out = {}
    with torch.inference_mode():
        logits, pre, pos = model.prefill_at(params, prompts, lengths)
        out["prefill_logits"] = logits.numpy()
        pools = model.init_paged_cache(b, b * bps, block_size, "cpu")
        model.insert_prefill(pools, pre, table, torch.arange(b))
        out["inserted"] = whole(pools)
        steps = []
        pos = pos.to(torch.int64)
        for i in range(g):
            logits, pools = model.decode_step(params, pools, forced[:, i],
                                              pos + i, table)
            steps.append(logits.numpy())
        out["decode_logits"] = np.stack(steps, 1)
        out["decoded"] = whole(pools)
    return out


def paged_route_whole(cfg, params_np, prompts, lengths, forced,
                      block_size) -> dict:
    """:func:`serve_mesh_paged` on one process, the model whole."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy
    return _paged_route(Transformer(cfg), tree_from_numpy(params_np, "cpu"),
                        prompts, lengths, forced, block_size,
                        lambda t: _copied(tree_to_numpy(t)))


def serve_mesh_engine(cfg, params_np, n_requests, prompt_lens, gen_lens,
                      n_slots, block_size, mesh_shape=None) -> dict:
    """A ``serve_continuous`` workload (``poisson_workload`` of
    ``n_requests``, seed 0) through a ``SlotEngine`` on the serving mesh
    ``mesh_shape`` (whole on this process where ``None``): every request's
    tokens, and the block table after each admission and step."""
    from repro_torch.serve import (SlotEngine, StepClock, poisson_workload,
                                   serve_continuous)
    from repro_torch.models.transformer import Transformer
    from repro_torch.utils.convert import tree_from_numpy
    with (_serving(cfg, params_np, mesh_shape) if mesh_shape else
          contextlib.nullcontext((Transformer(cfg), tree_from_numpy(
              params_np, "cpu")))) as (model, local):
        if local is None:
            return None
        workload = poisson_workload(n_requests, 4.0, cfg.vocab,
                                    prompt_lens=prompt_lens,
                                    gen_lens=gen_lens, seed=0)
        max_len = max(prompt_lens) + max(gen_lens)

        tables = []

        class Watched(SlotEngine):
            def step(self):
                out = super().step()
                tables.append(self._table_np.copy())
                return out

        engine = Watched(model, local, n_slots=n_slots, max_len=max_len,
                         block_size=block_size, device="cpu")
        report = serve_continuous(engine, workload, clock=StepClock())
        return {"tokens": {r.rid: list(r.out) for r in report.requests},
                "tables": np.stack(tables)}


def serve_mesh_checkpoint(arch, directory, mesh_shape) -> dict:
    """``load_federated_params`` of the checkpoint in ``directory`` (the
    ``arch`` smoke variant's) on the serving mesh: this rank's slices, and
    the slices made whole again, as numpy (``None`` outside the mesh)."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.launch.serve import load_federated_params, serve_on_mesh
    from repro_torch.models import sharding
    from repro_torch.models.transformer import Transformer
    from repro_torch.utils.convert import tree_to_numpy
    model = Transformer(smoke_variant(get_arch(arch)))
    with serve_on_mesh(model, mesh_shape) as mesh:
        if mesh.get_coordinate() is None:
            return None
        local = load_federated_params(model, directory, "cpu")
        grp = sharding.model_group()
        dims = sharding.param_split_dims(model.init(device="meta"),
                                         grp.size)
        return {"local": tree_to_numpy(local),
                "whole": tree_to_numpy(sharding.to_whole(local, dims, grp))}


def serve_mesh_shard_seq_refusals(cfg, params_np) -> dict:
    """What a long context's serving mesh (``shard_seq``) refuses on this
    rank of a world of 4, the engine on (2, 1) (as ``(exception type,
    message)``), and the split dims of the first attention layer's K / V
    caches on (2, 2), where ``cfg``'s KV heads divide the model axis: the
    pair (sequence dim, heads dim) each."""
    from repro_torch.launch.serve import serve_on_mesh
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import SlotEngine
    out = {}
    with _serving(cfg, params_np, (2, 1), shard_seq=True) as (model, local):
        try:
            SlotEngine(model, local, n_slots=2, max_len=8, device="cpu")
            out["engine"] = None
        except NotImplementedError as e:
            out["engine"] = (type(e).__name__, str(e))
    model = Transformer(cfg)
    with serve_on_mesh(model, (2, 2), shard_seq=True):
        kv = model.cache_dims(1, 64)[0]["0"]["mixer"]
        out["both"] = [kv["k"], kv["v"]]
    return out


# --------------------------- the serving clock -------------------------------

class _Ticks:
    """A stand-in for the scheduler's ``time`` module: ``perf_counter``
    advances by ``dt`` a call, so each unit of work measures ``dt``."""

    def __init__(self, dt: float):
        self.dt, self.now = dt, 0.0

    def perf_counter(self) -> float:
        self.now += self.dt
        return self.now


class _HostEngine:
    """The bookkeeping of a continuous-batching engine without a model (no
    collective of its own): ``admit`` takes free slots, ``step`` emits one
    token a running request (its rid) and releases those at their budget;
    ``log`` records every admission and step with the rids it touched."""

    def __init__(self, ctx, n_slots=2, max_len=64):
        self.rules_context = ctx
        self.n_slots, self.max_len, self.prefill_batch = n_slots, max_len, 2
        self.slots, self.steps, self.log = {}, 0, []

    @property
    def free_slots(self) -> int:
        return self.n_slots - len(self.slots)

    @property
    def n_active(self) -> int:
        return len(self.slots)

    @staticmethod
    def bucket_len(n: int) -> int:
        return n

    def admit(self, reqs):
        for r in reqs:
            self.slots[min(set(range(self.n_slots)) - set(self.slots))] = r
        self.log.append(("admit", [r.rid for r in reqs]))

    def _sync(self):
        pass

    def step(self):
        self.steps += 1
        emitted, finished = list(self.slots.values()), []
        for s, r in list(self.slots.items()):
            r.out.append(r.rid)
            if len(r.out) == r.max_gen:
                finished.append(self.slots.pop(s))
        self.log.append(("step", [r.rid for r in emitted]))
        return emitted, finished

    def stats(self) -> dict:
        return {"steps": self.steps}


class _HostModel:
    """``serve_static``'s model calls without a model: zero logits."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def prefill(self, params, tokens, max_len=None):
        return (torch.zeros((tokens.shape[0], self.vocab)), None,
                tokens.shape[1])

    def decode_step(self, params, caches, tok, pos):
        return torch.zeros((tok.shape[0], self.vocab)), caches


def serve_clock_schedules(cfg, dt) -> dict:
    """``serve_continuous`` (a host-only engine, :class:`_HostEngine`) and
    ``serve_static`` (:class:`_HostModel`) of one Poisson workload on this
    rank of the serving mesh (1, 2) under the default wall clock, the
    scheduler's measured times ``dt[rank]`` a unit of work
    (:class:`_Ticks`): each driver's admissions and steps in order, and
    every request's emission times and finish."""
    import torch.distributed as dist

    from repro_torch.launch.serve import serve_on_mesh
    from repro_torch.models import sharding
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import poisson_workload, scheduler
    out = {}
    real = scheduler.time
    scheduler.time = _Ticks(dt[dist.get_rank()])
    try:
        with serve_on_mesh(Transformer(cfg), (1, 2)):
            for driver in ("continuous", "static"):
                wl = poisson_workload(8, 4.0, cfg.vocab, seed=1,
                                      prompt_lens=(4,), gen_lens=(2, 3))
                if driver == "continuous":
                    engine = _HostEngine(sharding.current_context())
                    report = scheduler.serve_continuous(engine, wl)
                    log = engine.log
                else:
                    report = scheduler.serve_static(
                        _HostModel(cfg.vocab), {"w": torch.zeros(1)}, wl,
                        batch=2)
                    log = []
                out[driver] = {
                    "log": log, "duration": report.duration_s,
                    "requests": [(r.rid, list(r.emit_times), r.finished)
                                 for r in report.requests]}
    finally:
        scheduler.time = real
    return out
