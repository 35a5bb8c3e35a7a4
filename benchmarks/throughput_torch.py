"""Driver-throughput benchmark of the PyTorch port: per-round vs chunked
training, cohort scaling, the resident cohort, the kernel roofline and the
async straggler fleet. The port of ``benchmarks/throughput.py``, with every
scenario it has, on the card unless ``--device`` names another.

Measures end-to-end ``repro_torch.api.train`` throughput (rounds/s and
local-steps/s, batch building + prefetch + ledger included) on a fixed
small federation, across engine x compressor x chunk_rounds, and writes
``BENCH_throughput_torch.json`` (never the JAX package's
``BENCH_throughput.json``). ``chunk_rounds=1`` is the per-round driver (one
record materialized and, under a pipeline spec, one mask fetch a round);
``chunk_rounds=R`` runs R rounds per ``run_rounds`` call with at most one
blocking sync per chunk (``host_syncs_per_round`` reports that
driver-structural count, as the JAX benchmark does). The round runs the
``dp_clip_noise`` kernel on a CUDA device (``kernel_backend="auto"``), and
the qsgd rows ``quantize_decompress``.

The scenarios, as in the JAX benchmark:

- the driver grid: ``vmap`` / ``map`` x none / topk / qsgd x chunk 1 / 2 /
  8 (``--smoke``: two configs, chunks 1 and 8). The JAX grid's
  ``shard_map`` rows are reported as skipped, naming ROADMAP queue 1 item
  12;
- cohort scaling over the virtual population M (rounds/s and
  ``device_block_bytes``, both flat in M);
- the resident cohort (``resident_cache=S``) against the chunk-boundary
  driver at M = 10^5, at 0 blocking syncs a steady chunk;
- the kernel roofline: each of the three row kernels and its plain
  version timed on the same operands at the JAX benchmark's shapes, their
  outputs held equal (bitwise for QSGD and the gather; ``dp_clip_noise``'s
  y within 1e-5 and its norm within 1e-5 of itself), the flops and bytes
  from each kernel's ``cost`` and the bound from the H100 terms of
  :mod:`repro_torch.utils.roofline`;
- the async straggler fleet (simulated seconds to a target rho, sync
  barrier vs B-of-K buffered async);
- the mesh plane: skipped (item 12), as the JAX one is on fewer than 8
  devices.

``--check`` keeps every gate the JAX benchmark has (the fused driver at
0.8x or more of the per-round one for the pipeline configs; device bytes
flat in M and rounds/s within 0.5x across M; the resident row at 0 syncs
and within its margin; every kernel row memory-bound; async ahead of sync
in simulated seconds) and adds one: every kernel row matches its plain
version.

    PYTHONPATH=src python benchmarks/throughput_torch.py            # full grid
    PYTHONPATH=src python benchmarks/throughput_torch.py --smoke --check [--device cpu]
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.api import FederationSpec, init_state, train  # noqa: E402
from repro_torch.api.state import round_rho_charges  # noqa: E402
from repro_torch.asyncfl import (  # noqa: E402
    HeteroLatency,
    init_async_state,
    sync_round_duration,
    train_async,
)
from repro_torch.kernels import (  # noqa: E402
    cohort_gather_scatter,
    dp_clip_noise,
    quantize_decompress,
    ref,
)
from repro_torch.models.linear import init_linear, logreg_loss  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.population import (  # noqa: E402
    UniformCohort,
    cohort_batch,
    device_block_bytes,
    init_population_state,
    synthetic_population,
    train_population,
)
from repro_torch.utils.device import resolve_device  # noqa: E402
from repro_torch.utils.roofline import HBM_BW, RooflineTerms  # noqa: E402

# the JAX benchmark's fixed reference federation: small enough that driver
# overhead (what this benchmark tracks) dominates
C, TAU, DIM, BATCH = 8, 2, 32, 8
SIGMA, LR, CLIP = 0.5, 0.3, 1.0
ITEM_12 = "not ported to repro_torch yet (ROADMAP queue 1 item 12)"


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reference_spec(engine: str, compressor: str, participation: float,
                   **kw) -> FederationSpec:
    extra = {}
    if compressor != "none":
        extra["compression_ratio"] = 0.25
    extra.update(kw)
    return FederationSpec(
        n_clients=C, tau=TAU, loss_fn=logreg_loss, optimizer=sgd(LR),
        engine=engine, dp=True, clip_norm=CLIP,
        participation=participation, compressor=compressor,
        sigmas=(SIGMA,) * C, batch_sizes=(BATCH,) * C, **extra)


def make_sampler(dim: int = DIM, batch: int = BATCH):
    def sampler(m, tau, rng):
        return {"x": rng.normal(size=(tau, batch, dim)).astype(np.float32),
                "y": rng.integers(0, 2, size=(tau, batch)).astype(np.int32)}
    return sampler


def best_of_turns(runs: dict, repeats: int) -> dict:
    """Best-of-``repeats`` wall time of each of ``runs`` ({name: () ->
    seconds}), timed in turns: a slow stretch of a shared host then falls
    on every entry alike instead of on whichever ran last, and the ratios
    ``--check`` gates on compare like with like. The garbage collector
    runs once before the turns and stays off during each timed call, as in
    ``timeit``."""
    walls = {name: [] for name in runs}
    gc.collect()
    for _ in range(repeats):
        for name, run in runs.items():
            gc.disable()
            try:
                walls[name].append(run())
            finally:
                gc.enable()
    return {name: min(w) for name, w in walls.items()}


def time_drivers(spec: FederationSpec, rounds: int, chunks, repeats: int,
                 device) -> list[dict]:
    """One row per ``chunk_rounds`` in ``chunks``: the best-of-``repeats``
    wall time of ``train(..., chunk_rounds=...)``, the chunks timed in
    turns (:func:`best_of_turns`) after one untimed warm-up run each
    (kernel builds, allocator)."""
    sampler = make_sampler()

    def one_run(n_rounds: int, chunk_rounds: int) -> float:
        state = init_state(spec, init_linear(DIM, device=device), device)
        _sync(device)
        t0 = time.perf_counter()
        state, out = train(spec, state, sampler, max_rounds=n_rounds,
                           chunk_rounds=chunk_rounds)
        _sync(device)
        assert out["rounds"] == n_rounds
        return time.perf_counter() - t0

    for chunk in chunks:                                # warm-up
        one_run(min(rounds, max(1, chunk)), chunk)
    walls = best_of_turns({chunk: (lambda c=chunk: one_run(rounds, c))
                           for chunk in chunks}, repeats)
    return [_driver_row(spec, rounds, chunk, walls[chunk])
            for chunk in chunks]


def _driver_row(spec: FederationSpec, rounds: int, chunk_rounds: int,
                wall: float) -> dict:
    # blocking syncs per round, from the driver structure: the per-round
    # driver materializes each record (plus the mask fetch under a
    # pipeline spec); the chunked driver blocks once per chunk
    syncs = ((1.0 + (1.0 if spec.has_pipeline() else 0.0))
             if chunk_rounds <= 1 else 1.0 / chunk_rounds)
    return {
        "engine": spec.engine, "compressor": spec.compressor,
        "participation": spec.participation_fraction(),
        "chunk_rounds": chunk_rounds, "rounds": rounds,
        "wall_s": round(wall, 4),
        "rounds_per_s": round(rounds / wall, 2),
        "local_steps_per_s": round(rounds * TAU / wall, 2),
        "host_syncs_per_round": syncs,
    }


def _cohort_workload(m: int, resident: int):
    spec = reference_spec("vmap", "topk", 1.0).replace(population=m,
                                                       cohort_size=C)
    pop = synthetic_population(m, dim=DIM, batch_size=BATCH, seed=0,
                               stationary=bool(resident))
    return spec, pop


def _cohort_run(spec, pop, n_rounds: int, chunk_rounds: int, resident: int,
                device) -> float:
    ps = init_population_state(spec, init_linear(DIM, device=device), device)
    _sync(device)
    t0 = time.perf_counter()
    ps, out = train_population(spec, ps, pop, max_rounds=n_rounds,
                               chunk_rounds=chunk_rounds,
                               resident_cache=resident)
    _sync(device)
    assert out["rounds"] == n_rounds
    return time.perf_counter() - t0


def _cohort_row(spec, pop, m: int, rounds: int, chunk_rounds: int,
                resident: int, wall: float, device) -> dict:
    ps = init_population_state(spec, init_linear(DIM, device=device), device)
    batch = cohort_batch(spec, pop, UniformCohort(spec.seed)(0, m, C),
                         np.random.default_rng(0))
    # the driver-structural sync count, as the JAX benchmark gives it: the
    # chunk-boundary path pays the mask fetch and the ClientStore gather
    # and scatter-back a chunk; the resident driver under full
    # within-cohort participation pays none
    if resident:
        syncs = (0.0 if spec.participation_fraction() >= 1.0
                 else 1.0 / chunk_rounds)
    else:
        syncs = ((1.0 if spec.has_pipeline() else 0.0) + 2.0) / chunk_rounds
    row = {
        "mode": "resident" if resident else "chunk_boundary",
        "population": m, "cohort_size": C, "chunk_rounds": chunk_rounds,
        "rounds": rounds, "wall_s": round(wall, 4),
        "rounds_per_s": round(rounds / wall, 2),
        "host_syncs_per_round": round(syncs, 4),
        "device_block_bytes": device_block_bytes(ps, batch),
    }
    if resident:
        row["resident_cache"] = resident
    return row


def run_cohort_scaling(smoke: bool, device, rounds: int | None = None
                       ) -> list[dict]:
    """A K = C cohort drawn from M virtual clients (chunked, topk pipeline
    so the ClientStore residual path is on the clock), one row per M, the
    populations timed in turns (best-of each); rounds/s and device block
    bytes must both be flat in M."""
    if smoke:
        ms, n, chunk, repeats = [1_000, 100_000], 16, 8, 5
    else:
        ms, n, chunk, repeats = [1_000, 100_000, 1_000_000], 32, 8, 5
    n = rounds or n
    work = {m: _cohort_workload(m, 0) for m in ms}
    for spec, pop in work.values():                     # warm-up
        _cohort_run(spec, pop, chunk, chunk, 0, device)
    walls = best_of_turns(
        {m: (lambda w=w: _cohort_run(*w, n, chunk, 0, device))
         for m, w in work.items()}, repeats)
    rows = []
    for m in ms:
        r = _cohort_row(*work[m], m, n, chunk, 0, walls[m], device)
        rows.append(r)
        print(f"population M={m:<9,} K={C} chunk={chunk:<3} "
              f"{r['rounds_per_s']:>8.1f} rounds/s "
              f"({r['host_syncs_per_round']:.3f} syncs/round, "
              f"{r['device_block_bytes']:,} device bytes)", flush=True)
    return rows


def run_resident_cohort(smoke: bool, device, rounds: int | None = None
                        ) -> dict:
    """Resident vs chunk-boundary at M = 10^5, K = 8, timed in turns
    (:func:`best_of_turns`). The resident driver runs at its natural
    chunk of 32, the baseline at the scaling rows' 8 (the JAX benchmark's
    asymmetry)."""
    m = 100_000
    n, repeats = (32, 11) if smoke else (64, 7)
    n = rounds or n
    chunk_base, chunk_res = 8, 32
    cache = chunk_res * C               # S = 256: one full chunk of warm slots
    spec_b, pop_b = _cohort_workload(m, 0)
    spec_r, pop_r = _cohort_workload(m, cache)
    _cohort_run(spec_b, pop_b, chunk_base, chunk_base, 0, device)  # warm-up
    _cohort_run(spec_r, pop_r, chunk_res, chunk_res, cache, device)
    walls = best_of_turns({
        "baseline": lambda: _cohort_run(spec_b, pop_b, n, chunk_base, 0,
                                        device),
        "resident": lambda: _cohort_run(spec_r, pop_r, n, chunk_res, cache,
                                        device)}, repeats)
    base = _cohort_row(spec_b, pop_b, m, n, chunk_base, 0,
                       walls["baseline"], device)
    res = _cohort_row(spec_r, pop_r, m, n, chunk_res, cache,
                      walls["resident"], device)
    speedup = res["rounds_per_s"] / base["rounds_per_s"]
    print(f"resident   M={m:<9,} K={C} S={cache:<4} "
          f"{res['rounds_per_s']:>8.1f} rounds/s "
          f"({res['host_syncs_per_round']:.3f} syncs/round, "
          f"{speedup:.2f}x chunk-boundary)", flush=True)
    return {"baseline": base, "resident": res,
            "speedup_resident_vs_chunk": round(speedup, 2)}


def _kernel_scenarios(smoke: bool, device) -> list[dict]:
    """The three row kernels at the JAX benchmark's shapes, each beside its
    plain version and its ``cost``."""
    n = 1 << 16 if smoke else 1 << 20
    s_rows, d = (128, 256) if smoke else (512, 4096)
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn((1, n), generator=gen).to(device)
    u = torch.rand((1, n), generator=gen).to(device)
    noise = torch.randn((1, n), generator=gen).to(device)
    sigma = torch.full((1,), 0.5, device=device)
    cachemat = torch.randn((s_rows, d), generator=gen).to(device)
    slots = torch.as_tensor(np.arange(0, s_rows, s_rows // C)[:C],
                            dtype=torch.int32, device=device)
    return [
        {"kernel": "quantize_decompress", "shape": f"N={n}",
         "compare": _bitwise,
         "run": lambda: quantize_decompress.quantize_decompress(x, u, 4),
         "plain": lambda: ref.quantize_decompress_ref(x, u, 4),
         "cost": quantize_decompress.cost(1, n)},
        {"kernel": "cohort_gather_scatter", "compare": _bitwise,
         "shape": f"S={s_rows} K={C} D={d}",
         "run": lambda: cohort_gather_scatter.cohort_gather_scatter(
             cachemat, slots),
         "plain": lambda: ref.cohort_gather_scatter_ref(cachemat, slots),
         "cost": cohort_gather_scatter.cost(C, d, 4, 4)},
        {"kernel": "dp_clip_noise", "shape": f"N={n}",
         "compare": _within_1e5,
         "run": lambda: dp_clip_noise.dp_clip_noise(x, noise, 1.0, sigma),
         "plain": lambda: ref.dp_clip_noise_ref(x, noise, 1.0, sigma),
         "cost": dp_clip_noise.cost(1, n)},
    ]


def _time_us(fn, iters: int, repeats: int, device) -> float:
    """Best-of-``repeats`` mean microseconds of one call over ``iters``
    calls (CUDA events on the card), after a warm-up call."""
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(repeats):
        if torch.device(device).type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3 / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            best = min(best, (time.perf_counter() - t0) * 1e6 / iters)
    return best


def _bitwise(got, want) -> tuple[float, bool]:
    """(max |difference| over the outputs, every output bitwise equal)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(got, want))
    return err, all(torch.equal(a, b) for a, b in zip(got, want))


def _within_1e5(got, want) -> tuple[float, bool]:
    """dp_clip_noise: (max |dy|, |dy| <= 1e-5 and the norm within 1e-5 of
    itself; the norm's sum runs in another order)."""
    (y, norm), (wy, wnorm) = got, want
    err = float((y - wy).abs().max())
    rel = float(((norm - wnorm).abs() / wnorm.abs().clamp(min=1e-30)).max())
    return err, err <= 1e-5 and rel <= 1e-5


def run_kernel_roofline(smoke: bool, device) -> dict:
    """Each row kernel and its plain version on the same operands, timed
    and placed on the H100 roofline (f32 terms): achieved GB/s, the share
    of the HBM bandwidth, the bound and ``headroom_vs_h100`` = time /
    bound. On a CPU device the wrapper runs the plain version itself."""
    iters, repeats = (5, 2) if smoke else (20, 3)
    rows = []
    for sc in _kernel_scenarios(smoke, device):
        err, same = sc["compare"](sc["run"](), sc["plain"]())
        flops, nbytes = sc["cost"]
        terms = RooflineTerms(flops=float(flops), hbm_bytes=float(nbytes),
                              coll_bytes=0.0, dtype="float32")
        bound = max(terms.t_compute, terms.t_memory)
        for backend, fn in (("kernel", sc["run"]), ("plain", sc["plain"])):
            us = _time_us(fn, iters, repeats, device)
            row = {
                "kernel": sc["kernel"], "backend": backend,
                "shape": sc["shape"], "flops": float(flops),
                "hbm_bytes": float(nbytes),
                "wall_us": round(us, 3),
                "achieved_gflop_s": round(flops / us / 1e3, 2),
                "achieved_gb_s": round(nbytes / us / 1e3, 2),
                "fraction_of_h100_hbm_bw": round(
                    nbytes / (us * 1e-6) / HBM_BW, 6),
                "h100_bound_us": round(bound * 1e6, 4),
                "h100_bottleneck": ("compute" if terms.t_compute
                                    > terms.t_memory else "memory"),
                "headroom_vs_h100": round(us * 1e-6 / bound, 2),
                "h100_roofline": terms.as_dict(),
                "max_abs_err_vs_plain": err,
                "matches_plain": same,
            }
            rows.append(row)
            print(f"roofline {sc['kernel']:22s} {backend:6s} "
                  f"{sc['shape']:18s} {row['wall_us']:>10.2f} us "
                  f"{row['achieved_gb_s']:>8.2f} GB/s (bound "
                  f"{row['h100_bound_us']} us, "
                  f"{row['fraction_of_h100_hbm_bw']:.1%} of HBM, "
                  f"{row['h100_bottleneck']}); vs plain {err!r} "
                  f"{'ok' if row['matches_plain'] else 'MISMATCH'}",
                  flush=True)
    return {"iters": iters, "repeats": repeats, "rows": rows}


def run_mesh_plane(smoke: bool) -> dict:
    """The 2D mesh engine against the 1D shard_map plane: not ported."""
    return {"skipped": True,
            "reason": f"the mesh_2d and shard_map engines are {ITEM_12}"}


def run_async_hetero(smoke: bool, device, rounds: int | None = None
                     ) -> dict:
    """Simulated seconds to land ``rounds_sync`` full sync rounds' zCDP on
    a straggler fleet: the sync barrier's sum of per-round maxima against
    the B-of-K buffered-async driver's clock."""
    rounds_sync, buffer_size = (6, 2) if smoke else (12, 2)
    rounds_sync = rounds or rounds_sync
    flushes = rounds_sync * C // buffer_size
    spec = reference_spec("async_buffered", "none", 1.0,
                          buffer_size=buffer_size, staleness_alpha=0.5,
                          eps_th=1e9, c_th=1e9)
    lat = HeteroLatency(0, fleet=C, slow_factor=6.0)
    target_rho = rounds_sync * float(round_rho_charges(spec).sum())
    sync_sim = sum(sync_round_duration(lat, C, r)
                   for r in range(rounds_sync))
    sampler = make_sampler()
    rng = np.random.default_rng(0)
    st = init_async_state(spec, init_linear(DIM, device=device), sampler,
                          rng=rng, latency_model=lat, device=device)
    _sync(device)
    t0 = time.perf_counter()
    st, out = train_async(spec, st, sampler, max_rounds=flushes, rng=rng,
                          chunk_rounds=8, latency_model=lat)
    _sync(device)
    wall = time.perf_counter() - t0
    assert out["rounds"] == flushes
    landed = float(np.sum(st.fl.rho))
    assert landed >= target_rho * (1 - 1e-9), (landed, target_rho)
    row = {
        "fleet": C, "buffer_size": buffer_size,
        "rounds_sync": rounds_sync, "flushes": flushes,
        "target_rho_landed": round(target_rho, 6),
        "sync_sim_seconds": round(sync_sim, 4),
        "async_sim_seconds": round(out["sim_seconds"], 4),
        "sim_speedup": round(sync_sim / out["sim_seconds"], 2),
        "wall_s": round(wall, 4),
        "flushes_per_s": round(flushes / wall, 2),
    }
    print(f"async hetero  K={C} B={buffer_size} target_rho="
          f"{row['target_rho_landed']:.3f}: sync {row['sync_sim_seconds']}s "
          f"vs async {row['async_sim_seconds']}s simulated "
          f"({row['sim_speedup']}x, {row['flushes_per_s']:.1f} flushes/s)",
          flush=True)
    return row


def run_grid(smoke: bool, device=None, rounds: int | None = None) -> dict:
    """Every scenario; ``rounds`` cuts every scenario's round count (a
    quick structural run)."""
    device = resolve_device(device)
    if smoke:
        grid = [("vmap", "none", 1.0), ("vmap", "topk", 0.5)]
        chunks, n, repeats = (1, 8), 24, 5
    else:
        grid = [("vmap", "none", 1.0), ("vmap", "topk", 0.5),
                ("vmap", "qsgd", 1.0), ("map", "none", 1.0),
                ("shard_map", "none", 1.0), ("shard_map", "topk", 0.5)]
        chunks, n, repeats = (1, 2, 8), 64, 5
    n = rounds or n
    results = []
    for engine, compressor, participation in grid:
        if engine == "shard_map":
            for chunk in chunks:
                results.append({
                    "engine": engine, "compressor": compressor,
                    "participation": participation, "chunk_rounds": chunk,
                    "skipped": True, "reason": f"{engine} is {ITEM_12}"})
            print(f"{engine:10s} {compressor:5s} q={participation:<4} "
                  f"skipped ({ITEM_12})", flush=True)
            continue
        spec = reference_spec(engine, compressor, participation)
        for r in time_drivers(spec, n, chunks, repeats, device):
            chunk = r["chunk_rounds"]
            results.append(r)
            print(f"{engine:10s} {compressor:5s} q={participation:<4} "
                  f"chunk={chunk:<3} {r['rounds_per_s']:>8.1f} rounds/s "
                  f"({r['local_steps_per_s']:.0f} steps/s, "
                  f"{r['host_syncs_per_round']:.3f} syncs/round)",
                  flush=True)
    speedups = {}
    for engine, compressor, participation in grid:
        sel = {r["chunk_rounds"]: r["rounds_per_s"] for r in results
               if not r.get("skipped")
               and (r["engine"], r["compressor"], r["participation"])
               == (engine, compressor, float(participation))}
        if not sel:
            continue
        top = max(k for k in sel if k > 1)
        speedups[f"{engine}/{compressor}/q{participation}"] = round(
            sel[top] / sel[1], 2)
    return {
        "bench": "throughput",
        "config": {"n_clients": C, "tau": TAU, "dim": DIM, "batch": BATCH,
                   "sigma": SIGMA, "rounds": n, "smoke": smoke},
        "torch": torch.__version__,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "results": results,
        "speedup_fused_vs_per_round": speedups,
        "cohort_scaling": run_cohort_scaling(smoke, device, rounds),
        "resident_cohort": run_resident_cohort(smoke, device, rounds),
        "kernel_roofline": run_kernel_roofline(smoke, device),
        "async_hetero": run_async_hetero(smoke, device, rounds),
        "mesh_plane": run_mesh_plane(smoke),
    }


KERNELS = ("quantize_decompress", "cohort_gather_scatter", "dp_clip_noise")


def check(report: dict, timing: bool = True) -> list[str]:
    """The ``--check`` gates' failures (empty: passed). ``timing=False``
    keeps the gates that do not read a wall clock."""
    bad = []
    if timing:
        # the pipeline configs, where chunking is structural (a mask sync
        # a round against one a chunk); 0.8 for a shared host's noise
        slow = {k: v for k, v in report["speedup_fused_vs_per_round"].items()
                if "/none/q1.0" not in k and v < 0.8}
        if slow:
            bad.append(f"fused driver slower than per-round: {slow}")
    rows = report["cohort_scaling"]
    if len({r["device_block_bytes"] for r in rows}) != 1:
        bad.append(f"device block bytes vary with M: "
                   f"{[(r['population'], r['device_block_bytes']) for r in rows]}")
    if timing:
        base_rps = rows[0]["rounds_per_s"]
        slow_pop = [r for r in rows if r["rounds_per_s"] < 0.5 * base_rps]
        if slow_pop:
            bad.append(f"cohort rounds/s degrades with M: {slow_pop}")
    rc = report["resident_cohort"]
    if rc["resident"]["host_syncs_per_round"] != 0:
        bad.append(f"resident driver reports host syncs: {rc['resident']}")
    rc_margin = 0.85 if report["config"]["smoke"] else 1.0
    if timing and (rc["resident"]["rounds_per_s"]
                   < rc_margin * rc["baseline"]["rounds_per_s"]):
        bad.append(f"resident driver slower than the chunk-boundary path: "
                   f"{rc}")
    kr = report["kernel_roofline"]["rows"]
    covered = {r["kernel"] for r in kr}
    if not set(KERNELS) <= covered:
        bad.append(f"kernel roofline rows missing: {covered}")
    off_roof = [r for r in kr if r["h100_bottleneck"] != "memory"]
    if off_roof:
        bad.append(f"streamed kernel projects compute-bound: {off_roof}")
    mismatch = [(r["kernel"], r["max_abs_err_vs_plain"]) for r in kr
                if not r["matches_plain"]]
    if mismatch:
        bad.append(f"kernel differs from its plain version: {mismatch}")
    ah = report["async_hetero"]
    if ah["async_sim_seconds"] >= ah["sync_sim_seconds"]:
        bad.append(f"buffered-async no faster than the sync barrier in "
                   f"simulated time: {ah}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced grid (vmap only, 24 rounds)")
    ap.add_argument("--check", action="store_true",
                    help="fail if a gate fails (see the module docstring)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu without a GPU)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="cut every scenario's rounds to this count")
    ap.add_argument("--out", default="BENCH_throughput_torch.json")
    args = ap.parse_args(argv)
    if os.path.basename(args.out) == "BENCH_throughput.json":
        ap.error("BENCH_throughput.json is the JAX package's record")

    report = run_grid(args.smoke, args.device, args.rounds)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(f"wrote {args.out}")
    if args.check:
        bad = check(report)
        if bad:
            for b in bad:
                print(f"REGRESSION: {b}")
            return 1
        rc = report["resident_cohort"]
        print("throughput gate passed: fused driver within margin "
              f"(speedups: {report['speedup_fused_vs_per_round']}); "
              f"cohort scaling flat over M "
              f"({[r['population'] for r in report['cohort_scaling']]}); "
              f"resident cohort 0 syncs/round at "
              f"{rc['speedup_resident_vs_chunk']}x chunk-boundary; "
              f"roofline memory-bound and equal to the plain versions for "
              f"{sorted(KERNELS)}; async "
              f"{report['async_hetero']['sim_speedup']}x sync in simulated "
              f"seconds; mesh plane skipped (item 12)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
