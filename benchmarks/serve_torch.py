"""Serving-plane benchmark on the PyTorch port: tokens/s and per-token
latency vs offered load (``benchmarks/serve.py``'s workload, clocks and
gate on ``repro_torch.serve``).

Open-loop Poisson arrivals (every request a pure function of ``(seed,
rid)``) drive the continuous-batching :class:`repro_torch.serve.SlotEngine`
and the static-batch baseline over the SAME workload, on a
:class:`WallClock`: simulated time advances by the measured host seconds of
each prefill / decode (synchronised with the device) and jumps idle gaps,
so tokens/s is real engine speed and latency percentiles include real
queueing at the offered load.

Offered load is calibrated, not absolute: a saturated probe measures the
engine's aggregate decode capacity (tokens/s with all slots busy), then
each scenario offers ``load x capacity`` tokens/s of Poisson demand.
``load=2.0`` is the backpressure regime the queue-depth stats exist for.

    PYTHONPATH=src python benchmarks/serve_torch.py --smoke --check \\
        [--device cpu] [--out BENCH.json]

``--check`` gates: continuous batching strictly above the static baseline
on aggregate tokens/s at every load, and identical per-request tokens
between the two modes (greedy). ``--repeats N`` serves each load N times,
the two modes in turns (continuous first in even repeats, static first in
odd ones), and the gate compares each mode's median tokens/s: one run's
host time varies more than continuous batching's margin at a light load.
Writes ``--out`` (default ``BENCH_serve_torch.json``); the report names
the device it ran on.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_variant
from repro_torch.models.transformer import Transformer
from repro_torch.serve import (SlotEngine, WallClock, poisson_workload,
                               serve_continuous, serve_static)
from repro_torch.utils.device import resolve_device

PROMPT_LENS = (5, 8, 12)
GEN_LENS = (4, 9)
LOADS = (0.5, 1.0, 2.0)


def _build(arch: str, smoke: bool, n_slots: int, max_len: int,
           block_size: int, device):
    cfg = get_arch(arch)
    if smoke:
        cfg = smoke_variant(cfg)
    model = Transformer(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)
    engine = SlotEngine(model, params, n_slots=n_slots, max_len=max_len,
                        block_size=block_size, device=device)
    return model, params, engine


def _calibrate(engine, vocab: int) -> float:
    """Aggregate decode capacity (tokens/s) with every slot busy: serve a
    zero-arrival-gap probe and take the steady throughput."""
    probe = poisson_workload(2 * engine.n_slots, 1e9, vocab, seed=99,
                             prompt_lens=PROMPT_LENS, gen_lens=GEN_LENS)
    report = serve_continuous(engine, probe)
    return report.tokens_per_s


def _row(mode: str, load: float, offered: float, report) -> dict:
    s = report.summary()
    return {
        "mode": mode, "load": load,
        "offered_tokens_per_s": round(offered, 1),
        "tokens_per_s": s["tokens_per_s"],
        "p50_latency_ms": round(s["p50_latency_s"] * 1e3, 3),
        "p99_latency_ms": round(s["p99_latency_s"] * 1e3, 3),
        "requests": s["requests"], "tokens_out": s["tokens_out"],
        "max_queue_depth": s["max_queue_depth"],
        "occupancy_mean": s["occupancy_mean"],
    }


def run(arch: str, smoke: bool, n_slots: int, block_size: int,
        n_requests: int, device=None, repeats: int = 1) -> dict:
    device = resolve_device(device)
    max_len = max(PROMPT_LENS) + max(GEN_LENS)
    model, params, engine = _build(arch, smoke, n_slots, max_len,
                                   block_size, device)
    vocab = model.cfg.vocab
    engine.warmup(buckets=PROMPT_LENS)
    capacity = _calibrate(engine, vocab)
    mean_gen = float(np.mean(GEN_LENS))
    # warm the static path's per-length prefill shapes off the clock
    serve_static(model, params, poisson_workload(
        3, 1e9, vocab, seed=98, prompt_lens=PROMPT_LENS,
        gen_lens=GEN_LENS), batch=n_slots, max_len=max_len)

    def serve(mode, wl):
        if mode == "continuous":
            return serve_continuous(engine, wl, clock=WallClock())
        return serve_static(model, params, wl, clock=WallClock(),
                            batch=n_slots, max_len=max_len)

    rows, medians = [], []
    token_match = True
    for load in LOADS:
        offered = load * capacity
        rate = offered / mean_gen
        tps = {"continuous": [], "static": []}
        for k in range(repeats):
            order = ("continuous", "static") if k % 2 == 0 else \
                ("static", "continuous")
            reps = {}
            for mode in order:
                reps[mode] = serve(mode, poisson_workload(
                    n_requests, rate, vocab, seed=7,
                    prompt_lens=PROMPT_LENS, gen_lens=GEN_LENS))
            token_match &= all(a.out == b.out for a, b in zip(
                reps["continuous"].requests, reps["static"].requests))
            got = {}
            for mode in ("continuous", "static"):
                got[mode] = _row(mode, load, offered, reps[mode])
                if repeats > 1:
                    got[mode]["repeat"] = k
                rows.append(got[mode])
                tps[mode].append(got[mode]["tokens_per_s"])
            c, st = got["continuous"], got["static"]
            print(f"load={load:<4} continuous {c['tokens_per_s']:>8.1f} "
                  f"tok/s p99={c['p99_latency_ms']:>8.2f} ms | "
                  f"static {st['tokens_per_s']:>8.1f} tok/s "
                  f"p99={st['p99_latency_ms']:>8.2f} ms", flush=True)
        medians.append({"load": load, **{
            mode: float(np.median(v)) for mode, v in tps.items()}})

    return {
        "bench": "serve_torch",
        "config": {"arch": model.cfg.name, "smoke": smoke,
                   "n_slots": n_slots, "block_size": block_size or max_len,
                   "max_len": max_len, "n_requests": n_requests,
                   "prompt_lens": list(PROMPT_LENS),
                   "gen_lens": list(GEN_LENS),
                   "capacity_tokens_per_s": round(capacity, 1),
                   "compile_s": engine.stats()["compile_s"],
                   "repeats": repeats},
        "torch": torch.__version__,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "results": rows,
        "median_tokens_per_s": medians,
        "tokens_byte_identical": bool(token_match),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke model variant + reduced workload")
    ap.add_argument("--check", action="store_true",
                    help="fail unless continuous batching beats the "
                         "static baseline on aggregate tokens/s at every "
                         "mixed-length load, with identical tokens")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--requests", type=int, default=0,
                    help="workload size per load point (default 10 smoke, "
                         "32 full)")
    ap.add_argument("--repeats", type=int, default=1,
                    help="runs of each load, the two modes in turns; the "
                         "gate compares medians")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default="BENCH_serve_torch.json")
    args = ap.parse_args(argv)

    n_requests = args.requests or (10 if args.smoke else 32)
    report = run(args.arch, args.smoke, args.slots, args.block_size,
                 n_requests, args.device, args.repeats)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(f"wrote {args.out}")

    if args.check:
        if not report["tokens_byte_identical"]:
            print("REGRESSION: continuous and static emitted different "
                  "tokens for the same greedy workload")
            return 1
        slow = {m["load"]: (m["continuous"], m["static"])
                for m in report["median_tokens_per_s"]
                if m["continuous"] <= m["static"]}
        if slow:
            print(f"REGRESSION: continuous batching not above the static "
                  f"baseline (load -> (cont, static) median tok/s over "
                  f"{args.repeats} runs): {slow}")
            return 1
        print("serve gate passed: continuous > static at every load, "
              "tokens identical")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
