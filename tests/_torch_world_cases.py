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


@contextlib.contextmanager
def replayed(draws):
    """Make the drivers draw ``draws`` (one entry per round, in order):
    a (C, tau, N) noise array for a dense spec, ``(mask, noise,
    agg_rand)`` for a pipeline spec. Under a secure sum the pair masks
    come from a generator seeded alike on every rank (they cancel)."""
    if draws is None:
        yield
        return
    it = iter(draws)
    gen = torch.Generator().manual_seed(11)

    def noise_draw(key, params, tau):
        return torch.as_tensor(next(it)), key

    def pipeline_draw(key, params, tau, pipeline):
        mask, noise, agg_rand = next(it)
        agg_rand = None if agg_rand is None else torch.as_tensor(agg_rand)
        if pipeline.secure is not None:
            agg_rand = (agg_rand,
                        pipeline.secure.draw(gen, noise.shape[-1], "cpu"))
        return (torch.as_tensor(mask), torch.as_tensor(noise), agg_rand,
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


def cohort_and_dense(kw: dict, dim: int, rounds: int) -> dict:
    """The cohort path at M == C and the dense participation path, both
    under ``kw``'s engine: states and records of each."""
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
    return {"dense": state_numpy(s_d), "dense_records": rec_d,
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


def mesh_views() -> dict:
    """The meshes of :mod:`repro_torch.launch.mesh` seen from this rank of
    a world of 4, and the refusals."""
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
