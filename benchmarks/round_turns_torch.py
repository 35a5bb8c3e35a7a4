"""Steady ms per round of the port's main path and of its qsgd8_q50 row,
for several source trees of the repo in turns on one card.

The two federations are ``chip_smoke.py``'s phase 5 (Adult-like data split
by group, the design's tau and sigmas: ``chip_smoke.main_path_spec``) and
phase 6's qsgd8_q50 comm-sweep row (``chip_smoke._sweep_spec``: 16 IID
clients, tau 5, half of them participating, 8-bit QSGD). Each is timed as
phase 5 times it: the batches built beforehand, two warm-up rounds, then
``--rounds`` rounds of ``api.run_round`` between two synchronizations,
``--repeats`` times on the same state, no eval. Each turn also times the
round's draw alone (``core.fl.draw_round_noise`` /
``draw_pipeline_round`` at the state's key, ``--draws`` calls between two
synchronizations).

Each turn is its own process whose ``repro_torch`` is the tree's
(``TREE/src``), so two commits compare on one card in one call: unpack
the other commit with ``git archive`` into a git-ignored directory and
give both trees, parent first; the default order is A, B, B, A. The
specs and ``chip_smoke``'s constants come from this script's checkout,
so both trees run the same federations.

    python3 benchmarks/round_turns_torch.py PARENT_TREE . [--turns 0,1,1,0]
        [--rounds 20] [--repeats 3] [--draws 200] [--out FILE.json]

Prints the card's name and power limit, one JSON line a turn and a
summary line (each tree's median over its turns and repeats).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _time_rounds(torch, api, spec, state, batches, rounds, repeats):
    for b in batches[:2]:
        state, _ = api.run_round(spec, state, b, check_budgets=False)
    out = []
    for _ in range(repeats):
        _sync(torch)
        t0 = time.perf_counter()
        for b in batches[2:2 + rounds]:
            state, _ = api.run_round(spec, state, b, check_budgets=False)
        _sync(torch)
        out.append((time.perf_counter() - t0) * 1e3 / rounds)
    finite = all(bool(torch.isfinite(x).all()) for x in state.params.values())
    return out, state, finite


def _time_draws(torch, draw, draws):
    draw()
    _sync(torch)
    t0 = time.perf_counter()
    for _ in range(draws):
        draw()
    _sync(torch)
    return (time.perf_counter() - t0) * 1e3 / draws


def child(tree: str, rounds: int, repeats: int, draws: int,
          device: str) -> dict:
    """One turn: both federations on ``tree``'s ``repro_torch``."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch import api, data, optim
    from repro_torch.core import convergence as conv
    from repro_torch.core import design, fl
    from repro_torch.models import linear

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec, fed, _ = cs.main_path_spec(api, linear, data, conv, design, optim)
    fed2 = data.split_iid(data.adult_like(seed=0), 16)
    qspec = cs._sweep_spec(api, linear, optim, fl, fed2, 0.5, "qsgd", 0.25)
    rec = {"tree": tree, "repro_torch": api.__file__}
    for name, sp, fd in (("main", spec, fed), ("qsgd8_q50", qspec, fed2)):
        dim = fd.clients[0].x_train.shape[1]
        state = api.init_state(sp, linear.init_linear(dim, device=device),
                               device=device)
        rng = np.random.default_rng(2)
        batches = [api.round_batch(sp, fd.make_sampler(cs.BATCH), rng)
                   for _ in range(rounds + 2)]
        ms, state, finite = _time_rounds(torch, api, sp, state, batches,
                                         rounds, repeats)
        pipe = sp.aggregation_pipeline()
        if pipe is None:
            def draw():
                return fl.draw_round_noise(state.key, state.params, sp.tau)
        else:
            def draw():
                return fl.draw_pipeline_round(state.key, state.params,
                                              sp.tau, pipe)
        rec[name] = {"ms_per_round": ms, "finite": finite, "tau": sp.tau,
                     "draw_ms": _time_draws(torch, draw, draws)}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--turns", default=None,
                    help="comma-separated tree indices (default 0,1,1,0)")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--draws", type=int, default=200)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cpu checks the script without a card")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        print(json.dumps(child(args.child, args.rounds, args.repeats,
                               args.draws, args.device)), flush=True)
        return 0
    if not args.trees:
        ap.error("give at least one tree")
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0]
    else:
        card = args.device
    print(card, flush=True)
    n = len(args.trees)
    order = ([int(i) for i in args.turns.split(",")] if args.turns
             else list(range(n)) + list(reversed(range(n))))
    turns = []
    for i in order:
        tree = args.trees[i]
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child", tree,
             "--rounds", str(args.rounds), "--repeats", str(args.repeats),
             "--draws", str(args.draws), "--device", args.device],
            capture_output=True, text=True, timeout=1800,
            env=dict(os.environ, PYTHONPATH=""))
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["index"] = i
        turns.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {}
    for i, tree in enumerate(args.trees):
        mine = [t for t in turns if t["index"] == i]
        summary[tree] = {
            name: {"median_ms_per_round": statistics.median(
                       ms for t in mine for ms in t[name]["ms_per_round"]),
                   "median_draw_ms": statistics.median(
                       t[name]["draw_ms"] for t in mine)}
            for name in ("main", "qsgd8_q50")}
    ok = all(t[name]["finite"] for t in turns for name in ("main",
                                                           "qsgd8_q50"))
    print(json.dumps({"card": card, "summary": summary, "finite": ok}),
          flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"card": card, "turns": turns, "summary": summary}, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
