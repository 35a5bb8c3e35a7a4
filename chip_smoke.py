#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
  1. the card (nvidia-smi name and power limit) and the kernels' build;
  2. every kernel against its plain PyTorch version on the card, with the
     kernel's, the plain version's and the bound's times (quantize_decompress
     must be bit-identical);
  3. the main path at full width: DP-PASGD on adult_like() split by
     education (16 clients, d = 104) through repro_torch.api on cuda,
     engine "vmap", trained until a budget binds; the kernel's launches in
     that run must be 2 x tau x rounds;
  4. three rounds with kernel_backend="auto" against "ref" from one seed;
  5. the steady time of one round, and where its device time goes
     (torch.profiler, reported when it can trace; the rounds always run);
  6. the aggregation pipeline at full width: the comm sweep of
     benchmarks/fig4_resource_tradeoff.py (dense, topk25, topk25 at q 0.5,
     qsgd8 at q 0.5) on Adult-2 (adult_like(seed=0) split iid over 16
     clients) with benchmarks/common.run_dp_pasgd's spec, each row's
     rounds, cost, epsilon and both kernels' launches checked; then the
     qsgd8_q50 round's steady time and profile, as in phase 5;
  7. three qsgd8_q50 rounds with kernel_backend="auto" against "ref": without
     DP bitwise equal; with DP every param gap explained by the QSGD levels
     that dp_clip_noise's rounding flipped;
  8. the population plane at full width, M == C = 16: Adult-2 as
     population_from_federated(fed2, 32) with the topk25_q100 spec, through
     train_population per round and resident (chunk 4, S = 16): 19 rounds,
     570.0 and the JAX package's epsilon exactly, params bitwise equal to
     a dense train, the cache stats and cohort_gather_scatter's launches;
  9. the population quickstart's resident step (M = 100,000, K = 16,
     S = 256, chunk 8, 24 rounds, stationary Dirichlet(0.3) shards):
     bitwise equal to 24 run_cohort_round calls, the JAX package's epsilon,
     cost and cache stats exactly, the launch formula; then ms per round of
     the per-round, chunk-boundary and resident drivers, a profile of one
     steady resident chunk and its blocking host syncs.
Phase 2 also holds cohort_gather_scatter bitwise against its plain version
at the resident driver's shapes. The last two lines are the kernels' JSON
record and {"ok": true, "device": {...}}. Needs a CUDA GPU and the
repository's src/.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
C_TH, EPS_TH, DELTA = 1000.0, 4.0, 1e-4
BATCH, LR, CLIP = 32, 0.3, 1.0
SHAPES = ((16, 210), (23, 202), (16, 4_194_304))   # main path, Vehicle-1, big
QSGD_BITS = (1, 4, 8, 16)
# benchmarks/fig4_resource_tradeoff.py PIPELINES: (label, q, compressor, ratio)
PIPELINES = (("dense_q100", 1.0, "none", 1.0),
             ("topk25_q100", 1.0, "topk", 0.25),
             ("topk25_q50", 0.5, "topk", 0.25),
             ("qsgd8_q50", 0.5, "qsgd", 0.25))
SWEEP_TAU, SWEEP_K, SWEEP_EPS = 5, 100, 10.0
# cohort_gather_scatter: (S, K, D, dtype) - the residuals of phases 9 and 8,
# the data leaves (x, y) of phase 9, tests/test_kernels.py's shapes, and a
# 1 GiB cache where bandwidth means something
COHORT_SHAPES = ((256, 16, 42, "float32"), (16, 16, 210, "float32"),
                 (256, 16, 800, "float32"), (256, 16, 40, "int32"),
                 (9, 3, 5, "float32"), (16, 4, 33, "bfloat16"),
                 (64, 16, 4_194_304, "float32"))
# examples/population_quickstart.py: M, K, dim, batch, tau, sigma, rounds
QS_M, QS_K, QS_DIM, QS_BATCH, QS_TAU, QS_SIGMA, QS_ROUNDS = (
    100_000, 16, 20, 8, 5, 0.8, 24)
QS_CACHE, QS_CHUNK = 256, 8


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", flush=True)
    return 1


def _time_ms(fn, iters: int) -> float:
    """Mean device time of one call over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(rows: int, n: int, with_noise: bool) -> tuple[float, str]:
    """The least time the card could take for dp_clip_noise, and what
    bounds it. Bytes: g (and noise, sigma) read once, y and norm written
    once, f32. Operations: per element a square-and-add (2), the scale (1)
    and, with noise, a multiply-add (2)."""
    nbytes = 4 * (rows * n * (3 if with_noise else 2)
                  + rows * (2 if with_noise else 1))
    return _larger_bound(nbytes, rows * n * (5 if with_noise else 3))


def _qsgd_bound_ms(rows: int, n: int) -> tuple[float, str]:
    """The same for quantize_decompress. Bytes: x and u read once, y and
    scale written once, f32. Operations: per element abs and max (2),
    divide, add, floor (3), sign and two multiplies (3)."""
    return _larger_bound(4 * (3 * rows * n + rows), 8 * rows * n)


def _larger_bound(nbytes: int, ops: int) -> tuple[float, str]:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_FLOPS_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def check_kernels(torch, dp_clip_noise, dp_clip_noise_ref):
    """Phase 2: the kernel against its plain version at SHAPES, both
    variants. Returns (ok, record of the main-path shape, max abs err)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok, main, worst = True, None, 0.0
    for rows, n in SHAPES:
        g = torch.randn((rows, n), generator=gen, device="cuda")
        g *= torch.logspace(-4, 1, rows, device="cuda")[:, None]
        noise = torch.randn((rows, n), generator=gen, device="cuda")
        sigma = torch.rand((rows,), generator=gen, device="cuda") + 0.1
        iters = 20 if n > 1_000_000 else 200
        for with_noise in (True, False):
            nz = noise if with_noise else None
            y, norm = dp_clip_noise(g, nz, CLIP, sigma)
            wy, wn = dp_clip_noise_ref(g, nz, CLIP, sigma)
            torch.cuda.synchronize()
            err_y = float((y - wy).abs().max())
            err_n = float(((norm - wn).abs() / wn.abs().clamp(min=1e-30))
                          .max())
            good = (bool(torch.allclose(y, wy, atol=1e-6, rtol=1e-5))
                    and err_n <= 1e-5)
            ok &= good
            worst = max(worst, err_y)
            ms = _time_ms(lambda: dp_clip_noise(g, nz, CLIP, sigma), iters)
            plain_ms = _time_ms(lambda: dp_clip_noise_ref(g, nz, CLIP, sigma),
                                iters)
            bound_ms, bound_by = _bound_ms(rows, n, with_noise)
            print(f"kernel dp_clip_noise ({rows}, {n}) "
                  f"{'noise' if with_noise else 'clip-only'}: "
                  f"max|dy|={err_y:.3e} max rel|dnorm|={err_n:.3e} "
                  f"{'ok' if good else 'MISMATCH'}  kernel {ms:.5f} ms  "
                  f"plain {plain_ms:.5f} ms  bound {bound_ms:.6f} ms "
                  f"({bound_by})  library: none (no single PyTorch call "
                  f"computes this function)", flush=True)
            if (rows, n) == SHAPES[0] and with_noise:
                main = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by}
    return ok, main, worst


def check_qsgd_kernel(torch, quantize_decompress, quantize_decompress_ref):
    """Phase 2, quantize_decompress: bit-identical to its plain version at
    SHAPES and QSGD_BITS (y and scale), timed at 8 bits, the comm sweep's.
    Returns (ok, record of the main-path shape, max abs err)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    ok, main, worst = True, None, 0.0
    for rows, n in SHAPES:
        x = torch.randn((rows, n), generator=gen, device="cuda")
        x *= torch.logspace(-4, 1, rows, device="cuda")[:, None]
        x[0] = 0.0                               # an all-zero row
        u = torch.rand((rows, n), generator=gen, device="cuda")
        for bits in QSGD_BITS:
            y, scale = quantize_decompress(x, u, bits)
            wy, ws = quantize_decompress_ref(x, u, bits)
            torch.cuda.synchronize()
            err = float((y - wy).abs().max())
            good = bool(torch.equal(y, wy)) and bool(torch.equal(scale, ws))
            ok &= good
            worst = max(worst, err)
            line = (f"kernel quantize_decompress ({rows}, {n}) bits {bits}: "
                    f"max|dy|={err:.3e} scales "
                    f"{'equal' if bool(torch.equal(scale, ws)) else 'DIFFER'}"
                    f" {'ok' if good else 'MISMATCH'}")
            if bits == 8:
                iters = 20 if n > 1_000_000 else 200
                ms = _time_ms(lambda: quantize_decompress(x, u, bits), iters)
                plain_ms = _time_ms(
                    lambda: quantize_decompress_ref(x, u, bits), iters)
                bound_ms, bound_by = _qsgd_bound_ms(rows, n)
                line += (f"  kernel {ms:.5f} ms  plain {plain_ms:.5f} ms  "
                         f"bound {bound_ms:.6f} ms ({bound_by})  library: "
                         f"none (no single PyTorch call computes this "
                         f"function)")
                if (rows, n) == SHAPES[0]:
                    main = {"ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by}
            print(line, flush=True)
    return ok, main, worst


def check_cohort_kernel(torch, cohort_gather_scatter, ref, vector_width):
    """Phase 2, cohort_gather_scatter: gather and scatter bitwise equal to
    the plain version (index_select / index_copy_) at COHORT_SHAPES, the
    whole cache compared after a scatter; the kernel's, the plain version's
    and the library call's times beside the bound. Returns (ok, record of
    the main-path shape's gather, max abs err)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    ok, main, worst = True, None, 0.0
    for s, k, d, dtype in COHORT_SHAPES:
        dt = getattr(torch, dtype)
        if dt.is_floating_point:
            cache = torch.randn((s, d), generator=gen, device="cuda").to(dt)
            rows = torch.randn((k, d), generator=gen, device="cuda").to(dt)
        else:
            cache = torch.randint(-2**31, 2**31 - 1, (s, d), generator=gen,
                                  device="cuda", dtype=dt)
            rows = torch.randint(-2**31, 2**31 - 1, (k, d), generator=gen,
                                 device="cuda", dtype=dt)
        slots = torch.randperm(s, generator=gen, device="cuda")[:k]
        got = cohort_gather_scatter(cache, slots)
        want = ref(cache, slots)
        mine, plain = cache.clone(), cache.clone()
        cohort_gather_scatter(mine, slots, rows)
        ref(plain, slots, rows)
        torch.cuda.synchronize()
        err = max(float((got.double() - want.double()).abs().max()),
                  float((mine.double() - plain.double()).abs().max()))
        good = bool(torch.equal(got, want)) and bool(torch.equal(mine,
                                                                 plain))
        del mine, plain
        ok &= good
        worst = max(worst, err)
        iters = 20 if d > 1_000_000 else 200
        times = {
            "gather": _time_ms(lambda: cohort_gather_scatter(cache, slots),
                               iters),
            "gather plain": _time_ms(lambda: ref(cache, slots), iters),
            "gather library": _time_ms(
                lambda: torch.index_select(cache, 0, slots), iters),
            "scatter": _time_ms(
                lambda: cohort_gather_scatter(cache, slots, rows), iters),
            "scatter plain": _time_ms(lambda: ref(cache, slots, rows),
                                      iters),
            "scatter library": _time_ms(
                lambda: cache.index_copy_(0, slots, rows), iters)}
        bound_ms, bound_by = _larger_bound(
            2 * k * d * cache.element_size() + 8 * k, 0)
        print(f"kernel cohort_gather_scatter S={s} K={k} D={d} {dtype} "
              f"({vector_width(cache, rows)}-byte copies): gather and "
              f"scatter {'bitwise equal' if good else 'MISMATCH'}  "
              + "  ".join(f"{n} {t:.5f} ms" for n, t in times.items())
              + f"  bound {bound_ms:.6f} ms ({bound_by})", flush=True)
        if (s, k, d, dtype) == COHORT_SHAPES[0]:
            main = {"ms": times["gather"], "plain_ms": times["gather plain"],
                    "library_ms": times["gather library"],
                    "bound_ms": bound_ms, "bound_by": bound_by}
    return ok, main, worst


def run_main_path(torch, np, api, linear, data, conv, design, optim,
                  dp_clip_noise):
    """Phase 3: the quickstart flow at full width, until a budget binds."""
    fed = data.split_by_group(data.adult_like())
    dim = fed.clients[0].x_train.shape[1]
    consts = conv.ProblemConstants(eta=LR, lam=0.1, lip=0.3, alpha=0.8,
                                   xi2=0.05, dim=2 * dim + 2,
                                   n_clients=fed.n_clients)
    sol = design.DesignProblem(
        consts=consts, resource=design.ResourceModel(c1=100.0, c2=1.0),
        clip_norm=CLIP, batch_sizes=fed.batch_sizes(BATCH), delta=DELTA,
        eps_th=EPS_TH, c_th=C_TH).solve()
    spec = api.FederationSpec(
        n_clients=fed.n_clients, tau=sol.tau, loss_fn=linear.logreg_loss,
        optimizer=optim.sgd(LR), clip_norm=CLIP, dp=True, engine="vmap",
        sigmas=tuple(float(s) for s in sol.sigmas),
        batch_sizes=tuple(fed.batch_sizes(BATCH)), eps_th=EPS_TH,
        delta=DELTA, c_th=C_TH)
    xt, yt = fed.eval_arrays("test")
    eval_fn = linear.make_eval_fn(linear.logreg_loss, xt, yt)
    state = api.init_state(spec, linear.init_linear(dim, device="cuda"),
                           device="cuda")
    init_eval = eval_fn(api.eval_params(spec, state))
    planned, _ = api.rounds_within_budgets(spec, state, 10_000)
    torch.cuda.synchronize()
    dp_clip_noise.launches = 0
    t0 = time.perf_counter()
    state, out = api.train(spec, state, fed.make_sampler(BATCH),
                           eval_fn=eval_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dp_clip_noise.launches
    rounds = out["rounds"]
    majority = max(float(np.mean(yt)), 1.0 - float(np.mean(yt)))
    best = out["best"]
    binds = api.exceeds_budgets(spec, state)
    finite = all(bool(torch.isfinite(x).all())
                 for x in state.params.values())
    print(f"main path: adult_like() n={sum(c.n_train for c in fed.clients)} "
          f"train rows, {fed.n_clients} clients, d={dim}, "
          f"N={2 * dim + 2} params/client, batch {BATCH}; design K*={sol.k} "
          f"tau*={sol.tau} sigma*={sol.sigmas[0]:.4f}", flush=True)
    print(f"main path: rounds={rounds} (planned by the budgets {planned}) "
          f"max_epsilon={out['max_epsilon']:.6f} (budget {EPS_TH}) "
          f"resource_spent={out['resource_spent']} (budget {C_TH}) "
          f"binds={binds}", flush=True)
    print(f"main path: eval loss {init_eval['eval_loss']:.5f} -> "
          f"{best.get('eval_loss', float('nan')):.5f} (best, round "
          f"{best['round']}), best acc {best.get('eval_acc', 0.0):.4f}, "
          f"test majority-class rate {majority:.4f}", flush=True)
    print(f"main path: ms_per_round={wall / max(rounds, 1) * 1e3:.3f} (train "
          f"loop wall / rounds; host batches, eval and first-call costs "
          f"included) launches={launches} expected={2 * sol.tau * rounds}",
          flush=True)
    ok = (rounds > 0 and rounds == planned and finite and binds is not None
          and out["max_epsilon"] <= EPS_TH + 1e-6
          and out["resource_spent"] <= C_TH
          and best.get("eval_loss", float("inf")) < init_eval["eval_loss"]
          and launches == 2 * sol.tau * rounds)
    return ok, launches, spec, fed


def compare_backends(torch, np, api, linear, spec, fed):
    """Phase 4: 3 rounds on "auto" (the kernel) and on "ref" (its plain
    version) from one seed; the generator streams are the same."""
    finals = []
    for backend in ("auto", "ref"):
        s = spec.replace(kernel_backend=backend)
        state = api.init_state(s, linear.init_linear(
            fed.clients[0].x_train.shape[1], device="cuda"), device="cuda")
        rng = np.random.default_rng(1)
        for _ in range(3):
            state, _ = api.run_round(s, state, api.round_batch(
                s, fed.make_sampler(BATCH), rng), check_budgets=False)
        finals.append(state.params)
    torch.cuda.synchronize()
    diff = max(float((finals[0][k] - finals[1][k]).abs().max())
               for k in finals[0])
    print(f"auto vs ref, 3 rounds: max|dparams|={diff:.3e} (limit 1e-5)",
          flush=True)
    return diff <= 1e-5


def profile_rounds(torch, np, api, linear, spec, fed, label, n_timed=20):
    """Phase 5 (and the end of phase 6): steady per-round time of ``spec``'s
    round (batches built beforehand), then device time by kernel over 3
    rounds; ``label`` starts each line. The rounds always run; only the
    profiler's start, stop and report are optional. Returns whether every
    round left finite params."""
    from torch.profiler import ProfilerActivity, profile
    state = api.init_state(spec, linear.init_linear(
        fed.clients[0].x_train.shape[1], device="cuda"), device="cuda")
    rng = np.random.default_rng(2)
    batches = [api.round_batch(spec, fed.make_sampler(BATCH), rng)
               for _ in range(n_timed + 5)]
    for b in batches[:2]:
        state, _ = api.run_round(spec, state, b, check_budgets=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[2:2 + n_timed]:
        state, _ = api.run_round(spec, state, b, check_budgets=False)
    torch.cuda.synchronize()
    per_round = (time.perf_counter() - t0) * 1e3 / n_timed
    print(f"{label}: steady round (tau={spec.tau}, batches prebuilt, no "
          f"eval): {per_round:.3f} ms/round over {n_timed} rounds",
          flush=True)
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:        # noqa: BLE001 — the profiler is optional
        print(f"{label}: profile unavailable ({e!r})", flush=True)
        prof = None
    t0 = time.perf_counter()
    for b in batches[-3:]:
        state, _ = api.run_round(spec, state, b, check_budgets=False)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    finite = all(bool(torch.isfinite(x).all()) for x in state.params.values())
    print(f"{label}: {n_timed + 5} rounds, params finite: {finite}",
          flush=True)
    if prof is None:
        return finite
    try:
        prof.stop()
        averages = prof.key_averages()
    except Exception as e:        # noqa: BLE001 — the profiler is optional
        print(f"{label}: profile unavailable ({e!r})", flush=True)
        return finite
    events = [e for e in averages
              if e.device_type.name == "CUDA" and e.device_time_total > 0]
    device_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"{label}: profile, 3 rounds: wall {wall_ms:.3f} ms, device busy "
          f"{device_ms:.3f} ms ({device_ms / wall_ms:.1%}), "
          f"{sum(e.count for e in events)} kernel launches", flush=True)
    for e in sorted(events, key=lambda e: -e.device_time_total)[:8]:
        print(f"  {e.device_time_total / 1e3:9.4f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    host = [e for e in averages if e.device_type.name == "CPU"]
    print(f"{label}: profile, 3 rounds: host ops by self CPU time",
          flush=True)
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"  {e.self_cpu_time_total / 1e3:9.4f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    return finite


def _sweep_spec(api, linear, optim, fl, fed, q, compressor, ratio):
    """benchmarks/common.run_dp_pasgd's spec for one comm-sweep row: tau 5,
    K 100, eps_th 10, C_th 10 K (c1/tau + c2) that never binds."""
    x_m = fed.batch_sizes(BATCH)
    return api.FederationSpec(
        n_clients=fed.n_clients, tau=SWEEP_TAU, loss_fn=linear.logreg_loss,
        optimizer=optim.sgd(LR), clip_norm=CLIP, dp=True, participation=q,
        compressor=compressor, compression_ratio=ratio, compression_bits=8,
        sigmas=tuple(float(s) for s in fl.design_sigmas(
            SWEEP_K, CLIP, x_m, SWEEP_EPS, DELTA)),
        batch_sizes=tuple(x_m), eps_th=SWEEP_EPS, delta=DELTA,
        c_th=10 * SWEEP_K * (100.0 / SWEEP_TAU + 1.0), c1=100.0, c2=1.0,
        seed=0)


def run_comm_sweep(torch, np, api, linear, data, optim, fl, dp_clip_noise,
                   quantize_decompress):
    """Phase 6: the four comm-sweep rows at full width on cuda, each trained
    for K / tau rounds or until privacy binds, with eval every round.
    Returns (ok, the qsgd row's quantize_decompress launches, Adult-2)."""
    fed = data.split_iid(data.adult_like(seed=0), 16)
    dim = fed.clients[0].x_train.shape[1]
    xt, yt = fed.eval_arrays("test")
    eval_fn = linear.make_eval_fn(linear.logreg_loss, xt, yt)
    ok, qsgd_launches = True, 0
    for label, q, compressor, ratio in PIPELINES:
        spec = _sweep_spec(api, linear, optim, fl, fed, q, compressor,
                           ratio)
        state = api.init_state(spec, linear.init_linear(dim, device="cuda"),
                               device="cuda")
        init_loss = eval_fn(api.eval_params(spec, state))["eval_loss"]
        torch.cuda.synchronize()
        dp_clip_noise.launches = quantize_decompress.launches = 0
        t0 = time.perf_counter()
        state, out = api.train(spec, state, fed.make_sampler(BATCH),
                               max_rounds=SWEEP_K // SWEEP_TAU,
                               eval_fn=eval_fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        clip_launches = dp_clip_noise.launches
        q_launches = quantize_decompress.launches
        rounds, best = out["rounds"], out["best"]
        participants = sorted({r["participants"] for r in out["history"]})
        print(f"comm sweep {label}: rounds={rounds} "
              f"resource_spent={out['resource_spent']} "
              f"max_epsilon={out['max_epsilon']:.6f} participants per round "
              f"{participants} eval loss {init_loss:.5f} -> "
              f"{best['eval_loss']:.5f} (best, round {best['round']}) best "
              f"acc {best['eval_acc']:.4f} ms_per_round="
              f"{wall / max(rounds, 1) * 1e3:.3f} (train loop wall / rounds,"
              f" eval included) launches dp_clip_noise={clip_launches} "
              f"quantize_decompress={q_launches}", flush=True)
        good = (clip_launches == 2 * SWEEP_TAU * rounds
                and best["eval_loss"] < init_loss
                and all(bool(torch.isfinite(x).all())
                        for x in state.params.values()))
        if q == 1.0:
            good &= (rounds == 19
                     and round(out["max_epsilon"], 6) == 9.701942
                     and out["resource_spent"] == {"none": 1995.0,
                                                   "topk": 570.0}[compressor])
        else:
            good &= (rounds == 20 and out["resource_spent"] == 350.0
                     and participants == [8.0]
                     and out["max_epsilon"] <= SWEEP_EPS)
        if compressor == "qsgd":
            good &= q_launches == 2 * rounds
            qsgd_launches = q_launches
        else:
            good &= q_launches == 0
        ok &= good
        if not good:
            print(f"comm sweep {label}: CHECK FAILED", flush=True)
    return ok, qsgd_launches, fed


def compare_qsgd_routes(torch, np, api, linear, optim, fl, fed):
    """Phase 7: three qsgd8_q50 rounds on "auto" (both kernels) and on "ref"
    (their plain versions) from one seed. Without DP the QSGD kernel is the
    only difference, so params and residual must be bitwise equal. With DP,
    dp_clip_noise's FMA rounding can flip a stochastic-rounding level: each
    round runs both routes from the same state, and every param gap must be
    within the flipped levels' residual jumps / P + 1e-5."""
    dim = fed.clients[0].x_train.shape[1]
    spec = _sweep_spec(api, linear, optim, fl, fed, 0.5, "qsgd", 0.25)
    n_p = spec.participants_per_round()

    def flat(params):
        return torch.cat([params[k][0].reshape(-1) for k in sorted(params)])

    finals = []
    for backend in ("auto", "ref"):
        s = spec.replace(dp=False, kernel_backend=backend)
        state = api.init_state(s, linear.init_linear(dim, device="cuda"),
                               device="cuda")
        rng = np.random.default_rng(1)
        for _ in range(3):
            state, _ = api.run_round(s, state, api.round_batch(
                s, fed.make_sampler(BATCH), rng), check_budgets=False)
        finals.append(state)
    torch.cuda.synchronize()
    same = (all(torch.equal(finals[0].params[k], finals[1].params[k])
                for k in finals[0].params)
            and torch.equal(finals[0].residual, finals[1].residual))
    print(f"qsgd8_q50 auto vs ref, dp=False, 3 rounds: params and residual "
          f"bitwise {'equal' if same else 'DIFFERENT'}", flush=True)
    ok = same
    auto, ref = spec, spec.replace(kernel_backend="ref")
    state = api.init_state(auto, linear.init_linear(dim, device="cuda"),
                           device="cuda")
    rng = np.random.default_rng(1)
    for r in range(3):
        batch = api.round_batch(auto, fed.make_sampler(BATCH), rng)
        sa, _ = api.run_round(auto, state, batch, check_budgets=False)
        sr, _ = api.run_round(ref, state, batch, check_budgets=False)
        dres = (sa.residual - sr.residual).abs()
        flipped = dres > 1e-5
        dparams = (flat(sa.params) - flat(sr.params)).abs()
        allowed = (dres * flipped).sum(dim=0) / n_p + 1e-5
        good = bool((dparams <= allowed).all())
        ok &= good
        print(f"qsgd8_q50 auto vs ref, dp=True, round {r + 1} from one "
              f"state: max|dparams|={float(dparams.max()):.3e} "
              f"max|dresidual|={float(dres.max()):.3e} flipped "
              f"coordinates={int(flipped.sum())} "
              f"{'ok' if good else 'UNEXPLAINED GAP'}", flush=True)
        state = sa
    return ok


def _same_params(torch, a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def run_population_m_equals_c(torch, api, linear, optim, fl, pop_mod, fed,
                              cohort_gather_scatter):
    """Phase 8: Adult-2 as an M == C = 16 population with the topk25_q100
    spec, per round and resident (chunk 4, S = 16), against a dense train
    of the same spec and seed. The resident run's kernel launches: 2 per
    chunked round (residual gather + scatter) over 4 chunks of 4, 1 per
    chunk (the FLState's residual view), 1 for the first chunk's promotion
    and 1 for the flush before the 3-round budget tail."""
    dim = fed.clients[0].x_train.shape[1]
    spec = _sweep_spec(api, linear, optim, fl, fed, 1.0, "topk", 0.25)
    dense, dout = api.train(spec, api.init_state(
        spec, linear.init_linear(dim, device="cuda"), device="cuda"),
        fed.make_sampler(BATCH), max_rounds=SWEEP_K // SWEEP_TAU)
    pspec = spec.replace(population=fed.n_clients, cohort_size=fed.n_clients)
    pop = pop_mod.population_from_federated(fed, BATCH)
    ok = True
    for label, kw, launches_want in (
            ("per round", dict(chunk_rounds=1), 0),
            ("resident chunk 4 S 16", dict(chunk_rounds=4,
                                           resident_cache=16),
             2 * 16 + 4 + 1 + 1)):
        ps = pop_mod.init_population_state(
            pspec, linear.init_linear(dim, device="cuda"), device="cuda")
        torch.cuda.synchronize()
        cohort_gather_scatter.launches = 0
        t0 = time.perf_counter()
        ps, out = pop_mod.train_population(
            pspec, ps, pop, max_rounds=SWEEP_K // SWEEP_TAU, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cohort_gather_scatter.launches
        same = _same_params(torch, ps.fl.params, dense.params)
        stats = out.get("resident_cache")
        good = (out["rounds"] == dout["rounds"] == 19
                and out["resource_spent"] == dout["resource_spent"] == 570.0
                and out["max_epsilon"] == dout["max_epsilon"]
                == 9.701942456923485
                and same and launches == launches_want
                and stats in (None, {"hits": 48, "misses": 16,
                                     "evictions": 0, "flushes": 2}))
        ok &= good
        print(f"population M=C=16 {label}: rounds={out['rounds']} "
              f"resource_spent={out['resource_spent']} "
              f"max_epsilon={out['max_epsilon']!r} params vs dense train "
              f"{'bitwise equal' if same else 'DIFFERENT'} cache {stats} "
              f"cohort_gather_scatter launches={launches} (expected "
              f"{launches_want}) ms_per_round="
              f"{wall / max(out['rounds'], 1) * 1e3:.3f} (no eval) "
              f"{'ok' if good else 'CHECK FAILED'}", flush=True)
    return ok


def _quickstart_spec(api, linear, optim):
    return api.FederationSpec(
        n_clients=QS_K, tau=QS_TAU, loss_fn=linear.logreg_loss,
        optimizer=optim.sgd(0.3), clip_norm=1.0, dp=True,
        population=QS_M, cohort_size=QS_K, compressor="topk",
        compression_ratio=0.25, sigmas=(QS_SIGMA,) * QS_K,
        batch_sizes=(QS_BATCH,) * QS_K, eps_th=1e9, c_th=1e9)


def run_quickstart_resident(torch, np, api, linear, optim, pop_mod,
                            cohort_gather_scatter):
    """Phase 9: examples/population_quickstart.py's resident step on cuda
    against 24 per-round calls. Returns (ok, launches). Launch formula: 4
    per round (residual gather and scatter, the x and y shard gathers), 1
    per chunk (the residual view), the promotions (per chunk the cold
    residual rows and the 2 data leaves: 3, 3, and 4 in chunk 3, which
    also gathers its 126 evicted rows), and 1 for the final flush."""
    spec = _quickstart_spec(api, linear, optim)
    pop = pop_mod.synthetic_population(QS_M, dim=QS_DIM,
                                       batch_size=QS_BATCH, alpha=0.3,
                                       seed=0, stationary=True)
    want = 4 * QS_ROUNDS + 3 + (3 + 3 + 4) + 1
    rs = pop_mod.init_population_state(
        spec, linear.init_linear(QS_DIM, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    cohort_gather_scatter.launches = 0
    rs, out = pop_mod.train_population(spec, rs, pop, max_rounds=QS_ROUNDS,
                                       chunk_rounds=QS_CHUNK,
                                       resident_cache=QS_CACHE)
    torch.cuda.synchronize()
    launches = cohort_gather_scatter.launches
    ps = pop_mod.init_population_state(
        spec, linear.init_linear(QS_DIM, device="cuda"), device="cuda")
    rng = np.random.default_rng(0)
    for _ in range(QS_ROUNDS):
        ps, _ = pop_mod.run_cohort_round(spec, ps, pop, rng,
                                         check_budgets=False)
    torch.cuda.synchronize()
    vids = np.arange(QS_M)
    same = (_same_params(torch, ps.fl.params, rs.fl.params)
            and np.array_equal(ps.store.rho, rs.store.rho)
            and np.array_equal(ps.store.gather_residual(vids),
                               rs.store.gather_residual(vids)))
    finite = all(bool(torch.isfinite(x).all())
                 for x in rs.fl.params.values())
    stats = out["resident_cache"]
    hist = out["history"]
    ok = (same and finite and out["rounds"] == QS_ROUNDS
          and out["max_epsilon"] == 4.729618937506673
          and out["resource_spent"] == 720.0
          and stats == {"hits": 1, "misses": 382, "evictions": 126,
                        "flushes": 1}
          and rs.store.residual_rows() == 382 and launches == want)
    print(f"population quickstart resident (M={QS_M:,}, K={QS_K}, "
          f"S={QS_CACHE}, chunk {QS_CHUNK}): rounds={out['rounds']} "
          f"max_epsilon={out['max_epsilon']!r} "
          f"resource_spent={out['resource_spent']} cache {stats} residual "
          f"rows {rs.store.residual_rows()} loss {hist[0]['loss']:.5f} -> "
          f"{hist[-1]['loss']:.5f}; params, store.rho and every residual "
          f"row vs {QS_ROUNDS} run_cohort_round calls "
          f"{'bitwise equal' if same else 'DIFFERENT'}; "
          f"cohort_gather_scatter launches={launches} (expected {want}) "
          f"{'ok' if ok else 'CHECK FAILED'}", flush=True)
    return ok, launches, spec, pop


def time_population_drivers(torch, linear, pop_mod, spec, pop):
    """Phase 9: ms per round, eval off, of the per-round, chunk-boundary
    (chunk 8) and resident (chunk 8, S 256) drivers, each training 24
    rounds from a fresh state, in turns A B C C B A within this call."""
    drivers = {"per-round": dict(chunk_rounds=1),
               "chunk-boundary": dict(chunk_rounds=QS_CHUNK),
               "resident": dict(chunk_rounds=QS_CHUNK,
                                resident_cache=QS_CACHE)}
    order = list(drivers) + list(drivers)[::-1]
    times = {k: [] for k in drivers}
    for name in order:
        ps = pop_mod.init_population_state(
            spec, linear.init_linear(QS_DIM, device="cuda"), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ps, out = pop_mod.train_population(spec, ps, pop,
                                           max_rounds=QS_ROUNDS,
                                           **drivers[name])
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3 / out["rounds"])
    print("population drivers, ms per round over 24 rounds (eval off; "
          "turns per-round, chunk-boundary, resident, resident, "
          "chunk-boundary, per-round): " + "; ".join(
              f"{k} {v[0]:.3f} / {v[1]:.3f}" for k, v in times.items()),
          flush=True)


def profile_resident_chunk(torch, np, linear, pop_mod, spec, pop):
    """Phase 9: one steady resident chunk (the third of the run: 8 rounds,
    128 promotions, evictions) under torch.profiler, then the next chunk
    under torch.cuda.set_sync_debug_mode("warn") to count its blocking host
    syncs. Returns whether the chunks left finite params."""
    from torch.profiler import ProfilerActivity, profile
    st = pop_mod.init_population_state(
        spec, linear.init_linear(QS_DIM, device="cuda"), device="cuda")
    cache = pop_mod.init_resident_cache(spec, st, QS_CACHE, population=pop)
    rng = np.random.default_rng(0)

    def chunk(st):
        return pop_mod.run_resident_rounds(spec, st, pop, rng, cache,
                                           n_rounds=QS_CHUNK,
                                           check_budgets=False)[0]

    for _ in range(2):
        st = chunk(st)
    torch.cuda.synchronize()
    prof = None
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:        # noqa: BLE001 — the profiler is optional
        print(f"phase 9: profile unavailable ({e!r})", flush=True)
        prof = None
    t0 = time.perf_counter()
    st = chunk(st)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if prof is not None:
        try:
            prof.stop()
            averages = prof.key_averages()
            events = [e for e in averages if e.device_type.name == "CUDA"
                      and e.device_time_total > 0]
            device_ms = sum(e.device_time_total for e in events) / 1e3
            n_launch = sum(e.count for e in events)
            print(f"phase 9 resident chunk ({QS_CHUNK} rounds): wall "
                  f"{wall_ms:.3f} ms, device busy {device_ms:.3f} ms "
                  f"({device_ms / wall_ms:.1%}), {n_launch} kernel launches "
                  f"({n_launch / QS_CHUNK:.1f} per round)", flush=True)
            for e in sorted(events, key=lambda e: -e.device_time_total)[:8]:
                print(f"  {e.device_time_total / 1e3:9.4f} ms  "
                      f"x{e.count:<5d} {e.key[:90]}", flush=True)
            host = [e for e in averages if e.device_type.name == "CPU"]
            print("phase 9 resident chunk: host ops by self CPU time",
                  flush=True)
            for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
                print(f"  {e.self_cpu_time_total / 1e3:9.4f} ms  "
                      f"x{e.count:<5d} {e.key[:90]}", flush=True)
        except Exception as e:    # noqa: BLE001 — the profiler is optional
            print(f"phase 9: profile unavailable ({e!r})", flush=True)
    syncs = []

    def record(message, *args, **kwargs):
        # each blocking call warns once; keep the innermost repro_torch line
        # it came from
        if "called a synchronizing CUDA operation" in str(message):
            ours = [f for f in traceback.extract_stack()[:-1]
                    if "repro_torch" in f.filename]
            syncs.append(f"{Path(ours[-1].filename).name}:{ours[-1].lineno}"
                         if ours else "outside repro_torch")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            st = chunk(st)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"phase 9 resident chunk under set_sync_debug_mode: "
          f"{len(syncs)} blocking host syncs"
          + "".join(f"\n  x{syncs.count(o)} {o}" for o in sorted(set(syncs))),
          flush=True)
    return all(bool(torch.isfinite(x).all()) for x in st.fl.params.values())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port "
              "on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import api, data, optim
    from repro_torch import population as pop_mod
    from repro_torch.core import convergence as conv
    from repro_torch.core import design, fl
    from repro_torch.kernels import _build
    from repro_torch.kernels.cohort_gather_scatter import (
        cohort_gather_scatter,
        vector_width,
    )
    from repro_torch.kernels.dp_clip_noise import dp_clip_noise
    from repro_torch.kernels.quantize_decompress import quantize_decompress
    from repro_torch.kernels.ref import (
        cohort_gather_scatter_ref,
        dp_clip_noise_ref,
        quantize_decompress_ref,
    )
    from repro_torch.models import linear

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. card and build ---------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    for name, (secs, log) in _build.build_all().items():
        print(f"build {name}: {secs:.2f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}", flush=True)

    # -- 2. kernels against their plain versions --------------------------
    ok_k, main_rec, worst = check_kernels(torch, dp_clip_noise,
                                          dp_clip_noise_ref)
    ok_q, q_rec, q_worst = check_qsgd_kernel(torch, quantize_decompress,
                                             quantize_decompress_ref)
    ok_g, g_rec, g_worst = check_cohort_kernel(
        torch, cohort_gather_scatter, cohort_gather_scatter_ref,
        vector_width)

    # -- 3. main path ---------------------------------------------------------
    ok_m, launches, spec, fed = run_main_path(
        torch, np, api, linear, data, conv, design, optim, dp_clip_noise)

    # -- 4. kernel round against plain round ----------------------------------
    ok_b = compare_backends(torch, np, api, linear, spec, fed)

    # -- 5. steady rounds, and where their device time goes ----------------
    ok_s = profile_rounds(torch, np, api, linear, spec, fed, "phase 5")

    # -- 6. the aggregation pipeline: the comm sweep at full width ----------
    ok_c, q_launches, fed2 = run_comm_sweep(
        torch, np, api, linear, data, optim, fl, dp_clip_noise,
        quantize_decompress)
    ok_c &= profile_rounds(torch, np, api, linear, _sweep_spec(
        api, linear, optim, fl, fed2, 0.5, "qsgd", 0.25), fed2,
        "phase 6 qsgd8_q50")

    # -- 7. the pipeline's kernel route against its plain route -------------
    ok_r = compare_qsgd_routes(torch, np, api, linear, optim, fl, fed2)

    # -- 8. the population plane, M == C, against the dense path ------------
    ok_p8 = run_population_m_equals_c(torch, api, linear, optim, fl, pop_mod,
                                      fed2, cohort_gather_scatter)

    # -- 9. the population quickstart's resident step -------------------------
    ok_p9, g_launches, qs_spec, qs_pop = run_quickstart_resident(
        torch, np, api, linear, optim, pop_mod, cohort_gather_scatter)
    time_population_drivers(torch, linear, pop_mod, qs_spec, qs_pop)
    ok_p9 &= profile_resident_chunk(torch, np, linear, pop_mod, qs_spec,
                                    qs_pop)

    print(json.dumps({"kernels": [{
        "name": "dp_clip_noise", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dp_clip_noise.cu",
        "replaces": "src/repro/kernels/dp_clip_noise.py:54",
        "launches": launches, "max_abs_err": worst,
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": None}, {
        "name": "quantize_decompress", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize_decompress.cu",
        "replaces": "src/repro/kernels/quantize_decompress.py:44",
        "launches": q_launches, "max_abs_err": q_worst,
        "ms": q_rec["ms"], "plain_ms": q_rec["plain_ms"],
        "bound_ms": q_rec["bound_ms"], "bound_by": q_rec["bound_by"],
        "library_ms": None}, {
        "name": "cohort_gather_scatter", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cohort_gather_scatter.cu",
        "replaces": "src/repro/kernels/cohort_gather.py:64",
        "launches": g_launches, "max_abs_err": g_worst,
        "ms": g_rec["ms"], "plain_ms": g_rec["plain_ms"],
        "bound_ms": g_rec["bound_ms"], "bound_by": g_rec["bound_by"],
        "library_ms": g_rec["library_ms"]}]}), flush=True)
    for ok, what in ((ok_k, "a kernel disagrees with its plain version"),
                     (ok_q, "quantize_decompress is not bit-identical to "
                            "its plain version"),
                     (ok_m, "the main path's checks failed"),
                     (ok_b, "the kernel round disagrees with the plain "
                            "round"),
                     (ok_s, "the steady rounds gave non-finite params"),
                     (ok_c, "the comm sweep's checks failed"),
                     (ok_r, "the pipeline's kernel route disagrees with its "
                            "plain route"),
                     (ok_g, "cohort_gather_scatter is not bit-identical to "
                            "its plain version"),
                     (ok_p8, "the M == C population's checks failed"),
                     (ok_p9, "the quickstart resident step's checks "
                             "failed")):
        if not ok:
            return _fail(what)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
