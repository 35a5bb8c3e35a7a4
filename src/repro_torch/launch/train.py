"""End-to-end DP-PASGD training launcher for the transformer, driven by
``repro_torch.api`` (a port of the JAX package's ``repro/launch/train.py``).

Runs real training (allocates params) on the GPU unless ``--device``
names another device. The optimal-design solver (paper §7) can pick
(K, tau, sigma) from resource/privacy budgets before launch (``--tau 0``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \\
        --smoke --rounds 5 --clients 4 --tau 5 --eps 10 --cth 2000 \\
        [--device cpu]

``--chunk-rounds R`` runs R rounds per ``run_rounds`` call (the same math
and ledger as R single rounds, the next chunk's batches built while the
current one runs).

``--population M --cohort-size K`` switches to cohort execution over M
virtual clients (:mod:`repro_torch.population`): each round trains a
sampled cohort of K devices, and device memory is bounded by K
independent of M. ``--resident-cache S`` keeps S warm clients' sticky
state on the device and draws a fresh cohort every round.

``--async-buffer B`` switches to buffered-async federation
(:mod:`repro_torch.asyncfl`, engine ``async_buffered``): the server
aggregates the first B arrivals per flush on a simulated device clock
(``--latency-profile {uniform,lognormal,hetero}``) with staleness-damped
updates (``--staleness-alpha``) and dispatch-time privacy charging.

``--env-profile host`` re-execs the launcher once under tcmalloc
(:mod:`repro_torch.launch.env`); ``--env-profile cpu-mesh --host-devices
N`` runs it as N gloo ranks on this host, each driving the same
federation, rank 0 printing the summary and writing ``--save``. Under a
launcher that sets ``WORLD_SIZE`` (``torchrun``) the ranks come from the
environment. ``--engine shard_map`` splits the client axis over the ranks;
``--engine mesh_2d --mesh-shape dc,dm`` lays a (dc, dm) mesh over them,
padding clients that do not divide dc and, with dm > 1, splitting each
replica's weights and matmuls over the dm ranks of a slab (every arch:
attention and MLP on heads and ffn, RWKV6 and Mamba2 on heads, MoE on
experts; a model axis that does not divide them raises ``ValueError``).
Where the mesh holds every rank, each rank keeps only its slab of the
state between rounds (``api.init_state``); ``train`` and ``save_state``
run on it, and ``--save`` gathers it whole once, to the same checkpoint
a whole run writes.
``--replica-hint`` passes the arch's param + optimizer-state bytes
(``configs.shapes.replica_footprint_bytes``) to the spec as
``replica_bytes``: ``engine="auto"`` places a replica over the device's
memory on ``mesh_2d`` with a model axis large enough to split it, and
raises ``ValueError`` on a world too small for that. The model's params come
from a ``torch.Generator`` seeded with ``--seed``, so they differ from the
JAX launcher's; the summary's ``rounds``, ``max_epsilon`` and
``resource_spent`` do not depend on them.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from repro_torch.api import (
    FederationSpec,
    init_state,
    resolve_engine,
    save_state,
    train,
)
from repro_torch.api.engines import mesh_shape_for
from repro_torch.asyncfl import (
    LATENCY_PROFILES,
    init_async_state,
    latency_profile,
    save_async_state,
    train_async,
)
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.core.convergence import ProblemConstants
from repro_torch.core.design import DesignProblem, ResourceModel
from repro_torch.core.fl import design_sigmas
from repro_torch.data.tokens import FederatedTokenStream, TokenTaskConfig
from repro_torch.launch.env import (
    add_env_profile_args,
    apply_env_profile,
    host_ranks,
)
from repro_torch.launch.mesh import run_on_host_world, world_size
from repro_torch.models.transformer import Transformer
from repro_torch.optim import sgd
from repro_torch.population import (
    HeterogeneousCohort,
    init_population_state,
    population_from_sampler,
    save_population_state,
    train_population,
)
from repro_torch.utils.device import resolve_device


def build_federation(cfg, n_clients: int, tau: int, batch_size: int,
                     seq_len: int, sigmas, lr: float = 0.1,
                     clip_norm: float = 1.0, delta: float = 1e-4,
                     engine: str = "auto", seed: int = 0,
                     participation: float = 1.0, compressor: str = "none",
                     compression_ratio: float = 0.1,
                     compression_bits: int = 8, population: int = 0,
                     buffer_size: int | None = None,
                     staleness_alpha: float = 0.0, latency_model=None,
                     aggregator: str = "mean", trim_fraction: float = 0.1,
                     norm_bound_factor: float = 3.0,
                     secure_agg: bool = False, secure_frac_bits: int = 16,
                     dp_accounting: str = "local", attack: str = "none",
                     byzantine_fraction: float = 0.0,
                     attack_scale: float = 10.0,
                     replica_bytes: int | None = None,
                     mesh_shape: tuple[int, int] | None = None,
                     rng=None, device=None):
    """Assemble the ``repro_torch.api`` handles for a transformer federation
    on ``device`` (default: the GPU).

    Returns ``(model, spec, state, sampler)``: drive them with
    ``repro_torch.api.train(spec, state, sampler, ...)``. The
    aggregation-pipeline and trust-plane knobs pass through to the spec.

    ``population=M > 0`` switches to cohort execution
    (:mod:`repro_torch.population`): ``n_clients`` becomes the per-round
    cohort size K, the token stream spans all M virtual clients (lazy: only
    the sampled cohort's batches are ever synthesized), and the returned
    ``state`` is a ``PopulationState`` to drive with ``train_population``
    (wrap the sampler via ``population_from_sampler``).

    ``engine="async_buffered"`` returns an ``AsyncState`` (generation 0
    already dispatched: it consumes the first round batches from ``rng``,
    so pass the SAME ``rng`` to ``train_async``) to drive with
    ``train_async``; ``buffer_size`` / ``staleness_alpha`` /
    ``latency_model`` configure the flush and the simulated clocks.

    ``replica_bytes`` is the placement hint of ``engine="auto"`` and
    ``mesh_shape`` the (dc, dm) of ``mesh_2d``: a replica hint that the
    world is too small to split raises before anything is allocated.

    The model's params are ``Transformer.init`` from a ``torch.Generator``
    on ``device`` seeded with ``seed``.
    """
    device = resolve_device(device)
    model = Transformer(cfg)
    task = TokenTaskConfig(vocab=cfg.vocab, seq_len=seq_len,
                           n_clients=population or n_clients, seed=seed)
    stream = FederatedTokenStream(task, batch_size,
                                  prefix_len=cfg.prefix_len,
                                  d_model=cfg.d_model)
    spec = FederationSpec(
        n_clients=n_clients, tau=tau, loss_fn=model.loss_fn,
        optimizer=sgd(lr), engine=engine, dp=True, clip_norm=clip_norm,
        num_microbatches=1,
        participation=participation, compressor=compressor,
        compression_ratio=compression_ratio,
        compression_bits=compression_bits,
        aggregator=aggregator, trim_fraction=trim_fraction,
        norm_bound_factor=norm_bound_factor, secure_agg=secure_agg,
        secure_frac_bits=secure_frac_bits, dp_accounting=dp_accounting,
        attack=attack, byzantine_fraction=byzantine_fraction,
        attack_scale=attack_scale,
        population=population or None,
        cohort_size=n_clients if population else None,
        buffer_size=buffer_size if engine == "async_buffered" else None,
        staleness_alpha=(staleness_alpha if engine == "async_buffered"
                         else 0.0),
        sigmas=tuple(float(s) for s in np.asarray(sigmas)),
        batch_sizes=(batch_size,) * n_clients, delta=delta, seed=seed,
        replica_bytes=replica_bytes, mesh_shape=mesh_shape)
    if resolve_engine(spec) == "mesh_2d":
        mesh_shape_for(spec)        # a world too small raises here
    params0 = model.init(torch.Generator(device=device).manual_seed(seed),
                         device)
    if population:
        state = init_population_state(spec, params0, device)
    elif spec.is_async():
        state = init_async_state(spec, params0, stream.sampler, rng=rng,
                                 latency_model=latency_model, device=device)
    else:
        state = init_state(spec, params0, device)
    return model, spec, state, stream.sampler


def federation_meta(spec) -> dict:
    """The spec scalars a serving driver needs to rebuild a ``like`` FLState
    for ``load_state`` (see ``repro_torch.launch.serve
    .load_federated_params``); the JAX launcher's keys and values."""
    return {"n_clients": spec.n_clients, "tau": spec.tau,
            "compressor": spec.compressor,
            "compression_ratio": spec.compression_ratio,
            "compression_bits": spec.compression_bits,
            "participation": spec.participants_per_round(),
            "population": spec.population,
            "aggregator": spec.aggregator,
            "secure_agg": spec.secure_agg,
            "dp_accounting": spec.dp_accounting,
            "attack": spec.attack,
            "byzantine_fraction": spec.byzantine_fraction,
            "topology": spec.topology}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke variant of the arch")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--tau", type=int, default=0,
                    help="0 = let the optimal-design solver choose")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--eps", type=float, default=10.0)
    ap.add_argument("--delta", type=float, default=1e-4)
    ap.add_argument("--cth", type=float, default=2000.0)
    ap.add_argument("--c1", type=float, default=100.0)
    ap.add_argument("--c2", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the token task, the spec and the "
                         "model's init")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--engine", default="auto",
                    choices=("vmap", "map", "shard_map", "mesh_2d",
                             "async_buffered", "auto"),
                    help="shard_map / mesh_2d split the client axis over "
                         "the ranks (--env-profile cpu-mesh --host-devices "
                         "N, or a launcher's WORLD_SIZE)")
    ap.add_argument("--mesh-shape", default=None,
                    help="dc,dm ranks of the mesh_2d engine (client x "
                         "model); dm > 1 splits each replica over dm "
                         "ranks. Default: "
                         "repro_torch.mesh.placement.default_mesh_shape")
    ap.add_argument("--replica-hint", action="store_true",
                    help="pass the arch's param + optimizer-state bytes "
                         "(configs.shapes.replica_footprint_bytes) to the "
                         "spec: engine='auto' places a replica over the "
                         "device's memory on mesh_2d with a model axis "
                         "that splits it")
    ap.add_argument("--async-buffer", type=int, default=0,
                    help="B > 0 switches to buffered-async federation "
                         "(repro_torch.asyncfl): aggregate the first B "
                         "arrivals per flush on simulated device clocks, "
                         "redispatch immediately, pre-charge privacy at "
                         "dispatch")
    ap.add_argument("--latency-profile", default="uniform",
                    choices=LATENCY_PROFILES,
                    help="simulated per-device latency distribution (async "
                         "mode); 'hetero' couples slowness to the "
                         "Beta-availability cohort model")
    ap.add_argument("--latency-scale", type=float, default=1.0,
                    help="nominal simulated seconds per dispatch")
    ap.add_argument("--staleness-alpha", type=float, default=0.0,
                    help="staleness damping w(s) = 1/(1+s)^alpha applied "
                         "to late arrivals at the flush")
    add_env_profile_args(ap)
    ap.add_argument("--chunk-rounds", type=int, default=1,
                    help="run this many rounds per run_rounds call; eval "
                         "then happens at chunk boundaries only")
    ap.add_argument("--population", type=int, default=0,
                    help="train over M virtual clients with cohort "
                         "execution (repro_torch.population): only "
                         "--cohort-size devices are resident per round; "
                         "0 = dense resident clients")
    ap.add_argument("--cohort-size", type=int, default=0,
                    help="per-round cohort size K (population mode; "
                         "default: --clients)")
    ap.add_argument("--resident-cache", type=int, default=0,
                    help="S > 0 keeps a device-resident cache of S warm "
                         "virtual clients and draws a fresh cohort every "
                         "round; needs --population and --chunk-rounds > 1, "
                         "and S >= chunk_rounds * K")
    ap.add_argument("--cohort-hetero", action="store_true",
                    help="sample cohorts under the Beta-availability + "
                         "dropout heterogeneity model instead of uniform "
                         "K-of-M")
    ap.add_argument("--cohort-dropout", type=float, default=0.05,
                    help="mid-round dropout rate of the heterogeneity model")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="fraction of clients sampled per round")
    ap.add_argument("--compressor", default="none",
                    choices=("none", "topk", "randk", "qsgd"))
    ap.add_argument("--compress-ratio", type=float, default=0.1)
    ap.add_argument("--compress-bits", type=int, default=8)
    ap.add_argument("--aggregator", default="mean",
                    choices=("mean", "median", "trimmed_mean", "norm_bound"),
                    help="Eq.-7b reduction over participant updates")
    ap.add_argument("--trim-fraction", type=float, default=0.1,
                    help="per-end trim of --aggregator trimmed_mean")
    ap.add_argument("--norm-bound-factor", type=float, default=3.0,
                    help="--aggregator norm_bound rejects updates whose L2 "
                         "norm exceeds factor x median participant norm")
    ap.add_argument("--secure-agg", action="store_true",
                    help="pairwise-mask secure-aggregation simulation: the "
                         "server only ever materializes the masked "
                         "fixed-point SUM")
    ap.add_argument("--secure-frac-bits", type=int, default=16,
                    help="fixed-point fractional bits of --secure-agg")
    ap.add_argument("--dp-accounting", default="local",
                    choices=("local", "central"),
                    help="'central' (needs --secure-agg) accounts the "
                         "aggregate-only observer: per-step rho scales by "
                         "1/P for the P pooled participant noises")
    ap.add_argument("--attack", default="none",
                    choices=("none", "sign_flip", "scale"),
                    help="simulate byzantine upload corruption by a static "
                         "--byzantine-fraction subset of resident clients")
    ap.add_argument("--byzantine-fraction", type=float, default=0.0)
    ap.add_argument("--attack-scale", type=float, default=10.0,
                    help="multiplier of --attack scale")
    ap.add_argument("--save", default=None)
    args = ap.parse_args(argv)
    apply_env_profile(args.env_profile, host_devices=args.host_devices)
    n_ranks = host_ranks(args.env_profile, args.host_devices)
    if n_ranks > 1 and world_size() != n_ranks:     # not yet on the ranks
        from repro_torch.launch import train as launcher  # by module name,
        #   so the ranks unpickle it whether this runs as __main__ or not
        return run_on_host_world(n_ranks, launcher.run, args)[0]
    return run(args)


def run(args) -> int:
    """The launcher's work on parsed ``args``, on every rank of the world
    (if any): rank 0 prints and saves, the others stay quiet."""
    dist = torch.distributed
    if dist.is_initialized() and dist.get_rank() > 0:
        with open(os.devnull, "w") as quiet, \
                contextlib.redirect_stdout(quiet):
            return _run(args)
    return _run(args)


def _run(args) -> int:
    device = resolve_device(args.device)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)

    engine = args.engine
    if args.async_buffer > 0 and engine != "async_buffered":
        engine = "async_buffered"
    is_async = engine == "async_buffered"
    if is_async and args.population:
        raise SystemExit("--async-buffer and --population are mutually "
                         "exclusive (async fleets model heterogeneity via "
                         "--latency-profile hetero)")

    # in population mode the resident block is the cohort, not --clients
    n_resident = (args.cohort_size or args.clients if args.population
                  else args.clients)
    if args.population and not 0 < n_resident <= args.population:
        raise SystemExit(f"--cohort-size must be in [1, {args.population}]")

    if args.tau:
        tau, k = args.tau, args.rounds * args.tau
        sigmas = design_sigmas(k, args.clip, [args.batch] * n_resident,
                               args.eps, args.delta)
    else:
        # paper §7: solve for (K, tau, sigma) under the budgets
        consts = ProblemConstants(eta=args.lr, lam=0.5, lip=2.0, alpha=5.0,
                                  xi2=1.0, dim=1000, n_clients=n_resident)
        prob = DesignProblem(
            consts=consts, resource=ResourceModel(args.c1, args.c2),
            clip_norm=args.clip, batch_sizes=[args.batch] * n_resident,
            delta=args.delta, eps_th=args.eps, c_th=args.cth)
        sol = prob.solve()
        tau = sol.tau
        sigmas = np.asarray(sol.sigmas, np.float32)
        print(f"[design] K*={sol.k} tau*={tau} sigma*={sigmas[0]:.4f} "
              f"bound={sol.predicted_bound:.4f} cost={sol.cost:.0f}")

    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split(","))
                  if args.mesh_shape else None)
    replica_bytes = None
    if args.replica_hint:
        from repro_torch.configs.shapes import replica_footprint_bytes
        replica_bytes = replica_footprint_bytes(cfg, optimizer=sgd(args.lr))
        print(f"[mesh] replica footprint "
              f"{replica_bytes / 1024 ** 3:.2f} GiB (params + opt state)")

    latency_model = (latency_profile(args.latency_profile, seed=0,
                                     fleet=n_resident,
                                     scale=args.latency_scale)
                     if is_async else None)
    rng = np.random.default_rng(0)
    model, spec, state, sampler = build_federation(
        cfg, n_resident, tau, args.batch, args.seq, sigmas, lr=args.lr,
        clip_norm=args.clip, delta=args.delta, engine=engine,
        seed=args.seed, participation=args.participation,
        compressor=args.compressor, compression_ratio=args.compress_ratio,
        compression_bits=args.compress_bits, population=args.population,
        buffer_size=args.async_buffer or None,
        staleness_alpha=args.staleness_alpha,
        latency_model=latency_model,
        aggregator=args.aggregator, trim_fraction=args.trim_fraction,
        norm_bound_factor=args.norm_bound_factor,
        secure_agg=args.secure_agg, secure_frac_bits=args.secure_frac_bits,
        dp_accounting=args.dp_accounting, attack=args.attack,
        byzantine_fraction=args.byzantine_fraction,
        attack_scale=args.attack_scale, replica_bytes=replica_bytes,
        mesh_shape=mesh_shape, rng=rng, device=device)
    spec = spec.replace(eps_th=args.eps, c_th=args.cth,
                        c1=args.c1, c2=args.c2)
    t0 = time.time()
    if is_async:
        state, out = train_async(spec, state, sampler, max_rounds=args.rounds,
                                 rng=rng, chunk_rounds=args.chunk_rounds,
                                 latency_model=latency_model)
    elif args.population:
        pop = population_from_sampler(args.population, sampler,
                                      name="federated-tokens")
        cohort_sampler = (HeterogeneousCohort(seed=spec.seed,
                                              dropout=args.cohort_dropout)
                          if args.cohort_hetero else None)
        state, out = train_population(spec, state, pop,
                                      cohort_sampler=cohort_sampler,
                                      max_rounds=args.rounds,
                                      chunk_rounds=args.chunk_rounds,
                                      resident_cache=args.resident_cache)
    else:
        state, out = train(spec, state, sampler, max_rounds=args.rounds,
                           chunk_rounds=args.chunk_rounds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    summary = {
        "arch": cfg.name, "rounds": out["rounds"],
        "chunk_rounds": args.chunk_rounds,
        # an async flush that no participant reached records no loss
        "final_loss": (out["history"][-1].get("loss")
                       if out["history"] else None),
        "max_epsilon": out["max_epsilon"],
        "resource_spent": out["resource_spent"],
        "wall_s": round(dt, 1),
    }
    if is_async:
        summary.update({
            "buffer_size": spec.resolved_buffer_size(),
            "latency_profile": args.latency_profile,
            "staleness_alpha": args.staleness_alpha,
            "sim_seconds": out["sim_seconds"],
        })
    if args.population:
        summary.update({
            "population": args.population, "cohort_size": n_resident,
            # sampled != realized under --participation < 1: the cohort
            # counter ticks for every sampled client, the rho ledger only
            # for clients that actually ran (and spent privacy)
            "distinct_sampled":
                int((state.store.rounds_participated > 0).sum()),
            "distinct_participants": int((state.store.rho > 0).sum()),
        })
        if "resident_cache" in out:
            summary["resident_cache"] = out["resident_cache"]
    print(json.dumps(summary, indent=2))
    if args.save:
        extra = {"history": out["history"], **federation_meta(spec)}
        if is_async:
            save_async_state(args.save, state, extra=extra)
        elif args.population:
            save_population_state(args.save, state, extra=extra)
        else:
            save_state(args.save, state, extra=extra)
        print(f"saved federation state to {args.save}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
