"""Single-card dry run: trace every (arch x input shape) combination of the
full-width model on ``meta`` tensors, count its work with
:func:`repro_torch.utils.cost.cost_of`, and place it on the H100 roofline
of :mod:`repro_torch.utils.roofline`. No tensor is allocated: params,
inputs and caches are meta tensors, and every kernel wrapper counts its
``cost`` without running.

The port of the JAX package's ``repro/launch/dryrun.py``, for one card:

- ``train`` shapes trace one DP-PASGD round (tau local steps + the
  average; Eq. 7a-7b) of the ``vmap`` engine's round function with its
  (C, tau, N) noise operand; ``prefill`` shapes trace ``prefill``;
  ``decode`` shapes trace one ``decode_step`` against a full cache.
- The record has the JAX record's fields: ``n_params``, ``active_params``,
  ``tokens_per_step``, flops and bytes (``cost_analysis_raw``),
  ``live_bytes_per_device`` (params + optimizer state + inputs + caches +
  the trace's peak of temporaries), ``fits_hbm`` against the card's
  79.18 GiB, and ``roofline``.

Not ported (ROADMAP queue 1 item 12): ``--multi-pod``,
``make_production_mesh``, ``mesh_report`` and the sharding rules, which
place the program on a TPU mesh; ``--multi-pod`` raises. The ``--opt``
names that only steer XLA's lowering (``scan_accum``, ``gather_weights``,
``ddp``, ``no_donate``) raise ``ValueError``: the port's decode writes its
caches in place, as a donated JAX cache is.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out-dir experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace

import torch

from repro_torch.api.engines import H100_MEM_BYTES, get_engine
from repro_torch.api.spec import FederationSpec, _not_ported
from repro_torch.configs import ASSIGNED_ARCHS, get_arch
from repro_torch.configs.shapes import (
    InputShape,
    get_shape,
    input_specs,
    param_count_estimate,
    supports_shape,
)
from repro_torch.models.transformer import Transformer
from repro_torch.optim import sgd
from repro_torch.utils.cost import Cost, cost_analysis_dict, cost_of
from repro_torch.utils.roofline import (
    RooflineTerms,
    active_params,
    model_flops_estimate,
)
from repro_torch.utils.tree import tree_leaves, tree_map

HBM_PER_CARD = H100_MEM_BYTES     # an H100 80GB: 79.18 GiB
MESH = "1xH100"
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def param_count(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def _bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _stack_clients(tree, c):
    return tree_map(lambda x: torch.empty((c,) + tuple(x.shape),
                                          dtype=x.dtype, device="meta"),
                    tree)


# ---------------------------------------------------------------------------
# tracing builders
# ---------------------------------------------------------------------------

ACT_BUDGET_BYTES = 5e9   # per-device activation-carry budget for training


def _auto_microbatches(cfg, shape, n_clients: int, replica: int) -> int:
    """Split each client's local batch into sequential microbatches so the
    per-device remat carry (L x B_micro x S x d x 2B) stays under budget."""
    per_client_b = shape.global_batch // n_clients
    n_layers = sum(s.n_steps * len(s.pattern) for s in cfg.segments)
    d_act = cfg.d_model * (2 if cfg.ssm_state else 1)
    seq = shape.seq_len + cfg.prefix_len
    bytes_per_seq = seq * d_act * 2 * n_layers
    b_micro_dev = max(1, int(ACT_BUDGET_BYTES // bytes_per_seq))
    need = max(1, -(-per_client_b // (replica * b_micro_dev)))  # ceil
    # round up to a divisor of the per-client batch
    n_mb = need
    while per_client_b % n_mb:
        n_mb += 1
    return min(n_mb, per_client_b)


def _linear(terms, peak: int) -> Cost:
    """The cost sum(w * cost) over ``terms`` ((w, Cost) pairs): flops,
    bytes and every op's calls, flops and bytes, with ``peak`` live
    bytes."""
    by_op: dict = {}
    for w, c in terms:
        for k, rec in c.by_op.items():
            acc = by_op.setdefault(k, {"calls": 0, "flops": 0.0, "bytes": 0})
            for f in acc:
                acc[f] += w * rec[f]
    for rec in by_op.values():
        rec["calls"] = int(round(rec["calls"]))
        rec["bytes"] = int(round(rec["bytes"]))
    return Cost(flops=sum(w * c.flops for w, c in terms),
                hbm_bytes=sum(w * c.hbm_bytes for w, c in terms),
                peak_live_bytes=int(peak),
                by_op={k: v for k, v in by_op.items() if v["calls"]})


def _with_steps(cfg, steps):
    segs = tuple(replace(s, n_steps=k) for s, k in zip(cfg.segments, steps))
    return replace(cfg, segments=segs,
                   n_layers=sum(k * len(s.pattern)
                                for s, k in zip(cfg.segments, steps)))


DIRECT_STEPS = 4      # a segment this deep or shallower is traced whole


def _by_depth(cfg, count) -> Cost:
    """``count(cfg)`` at the config's full depth, from shallow traces, as
    the JAX dry run multiplies a scanned layer's HLO by its trip count.
    ``count`` runs on the config with every segment cut to at most
    DIRECT_STEPS steps, then, for each segment deeper than that, at 2 and
    3 steps; each count is extended to the segment's n steps as the
    polynomial of degree 2 through its 2, 3 and 4-step points. Flops are
    linear in n; bytes are not quite: the gradient of a step's slice of
    the stacked (n_steps, ...) params is a full (n_steps, ...) tensor
    (``select_backward``) summed over the steps, so a round's traffic has
    a term in n^2 (a 1-step segment is left out of the fit: its params
    are views, and its backward differs). The peak of live storage grows
    by what a step keeps (its caches, its saved activations), extended
    from the step from 3 to 4."""
    short = [min(seg.n_steps, DIRECT_STEPS) for seg in cfg.segments]
    base = count(_with_steps(cfg, short))
    terms, peak = [(1, base)], base.peak_live_bytes
    for i, seg in enumerate(cfg.segments):
        n = seg.n_steps
        if n <= DIRECT_STEPS:
            continue
        c2, c3 = (count(_with_steps(cfg, short[:i] + [k] + short[i + 1:]))
                  for k in (2, 3))
        t = (n - 2) * (n - 3) // 2
        # c(n) - c(4), with c(4) = base
        terms += [(1 - (n - 2) + t, c2), ((n - 2) - 2 * t, c3),
                  (t - 1, base)]
        peak += (n - DIRECT_STEPS) * (base.peak_live_bytes
                                      - c3.peak_live_bytes)
    return _linear(terms, peak)


SEQ_POINTS = (16, 32, 48)     # the sequence lengths a recurrence is traced at


def _per_token(cfg) -> bool:
    """Every layer an RWKV6 recurrence: its training route
    (``rwkv.wkv6_scan``) is a Python loop over the tokens."""
    return all(ls.mixer == "rwkv6" for ls in cfg.layer_specs())


def _by_seq(seq: int, count) -> Cost:
    """``count(s)`` at sequence length ``seq``, from SEQ_POINTS: the
    polynomial of degree 2 in s through them (the loop's work is linear in
    s, and the gradient of each token's slice is a full (B, s, ...) tensor,
    so its traffic has a term in s^2), as the JAX dry run multiplies a
    ``lax.scan`` body by its trip count. The peak of live storage (the
    saved activations) is extended linearly from the last two points."""
    s1, s2, s3 = SEQ_POINTS
    h = s2 - s1
    if s3 - s2 != h or (seq - s1) % h:
        raise ValueError(f"seq {seq} is not on the grid of {SEQ_POINTS}")
    x = (seq - s1) // h
    c1, c2, c3 = count(s1), count(s2), count(s3)
    w = (1 - x + x * (x - 1) // 2, x - x * (x - 1), x * (x - 1) // 2)
    return _linear(list(zip(w, (c1, c2, c3))),
                   c3.peak_live_bytes + (seq - s3) // h
                   * (c3.peak_live_bytes - c2.peak_live_bytes))


def _round_cost(cfg, shape, n_clients: int, tau: int, lr: float,
                n_mb: int) -> Cost:
    """One round's cost from three small rounds, each at full depth by
    :func:`_by_depth` (see :func:`trace_train`)."""
    opt = sgd(lr)
    mb = shape.global_batch // n_clients // n_mb
    sigmas = torch.empty((n_clients,), dtype=torch.float32, device="meta")

    def one(c, t: int, k: int) -> Cost:
        model = Transformer(c)
        params1 = model.init(device="meta")
        sub = InputShape(shape.name, shape.seq_len, n_clients * k * mb,
                         "train")
        spec = FederationSpec(n_clients=n_clients, tau=t,
                              loss_fn=model.loss_fn, optimizer=opt,
                              engine="vmap", clip_norm=1.0, dp=True,
                              num_microbatches=k, vmap_microbatches=False)
        noise = torch.empty((n_clients, t, param_count(params1)),
                            dtype=torch.float32, device="meta")
        return cost_of(get_engine("vmap")(spec),
                       _stack_clients(params1, n_clients),
                       _stack_clients(opt.init(params1), n_clients),
                       input_specs(c, sub, n_clients=n_clients, tau=t),
                       noise, sigmas)[0]

    def traced(t: int, k: int) -> Cost:
        return _by_depth(cfg, lambda c: one(c, t, k))

    if n_mb == 1:
        c1, c2 = traced(1, 1), traced(2, 1)
        # a step: c2 - c1; the rest (the average): 2 c1 - c2
        return _linear([(tau - 1, c2), (2 - tau, c1)],
                       (c1 if tau == 1 else c2).peak_live_bytes)
    c12, c13, c22 = traced(1, 2), traced(1, 3), traced(2, 2)
    # a microbatch: c13 - c12; a step at 2: c22 - c12; the rest: 2 c12 -
    # c22; so tau (step(2) + (M - 2) microbatch) + rest
    m = n_mb - 2
    p12, p13, p22 = (c.peak_live_bytes for c in (c12, c13, c22))
    return _linear([(tau * m, c13), (-tau * m, c12), (tau, c22),
                    (-tau, c12), (2, c12), (-1, c22)],
                   (p12 if tau == 1 else p22) + m * (p13 - p12))


def trace_train(cfg, shape, n_clients: int, tau: int, lr: float = 0.1,
                microbatches: int | None = None):
    """Count one DP-PASGD round (tau local steps + 1 averaging), Eq.
    7a-7b, of the ``vmap`` engine on meta tensors. Returns ``(cost,
    n_params, tokens, microbatches, resident bytes)``.

    A round repeats the same ops for every local step and every
    microbatch, so its work is linear in both: the dry run traces three
    small rounds (tau 1 and 2 over one microbatch, or, when the client
    batch is split, (tau, microbatches) = (1, 2), (1, 3), (2, 2)) at one
    microbatch's batch, each extended to full depth by :func:`_by_depth`,
    and extends the counts to tau steps of M microbatches (a full trace
    of a 64-microbatch round of an 80-layer model takes tens of minutes
    of host time). The peak of live storage is the one at 2 local steps
    (a step's buffers outlive it by one step, so later steps add nothing),
    plus what each microbatch past the second adds (its stacked clipped
    gradient). An all-RWKV6 model's training loop runs over every token in
    Python, so it is traced at SEQ_POINTS (its chunked loss cut to the
    same number of chunks) and extended by :func:`_by_seq`. The resident
    bytes (params, optimizer state, the batch, the (C, tau, N) noise) are
    the full round's."""
    n = param_count_estimate(cfg)
    n_mb = microbatches or _auto_microbatches(cfg, shape, n_clients, 1)
    if _per_token(cfg) and shape.seq_len > SEQ_POINTS[-1]:
        def at_seq(s):
            c = cfg
            if cfg.loss_chunk:
                if cfg.loss_chunk * s % shape.seq_len:
                    raise ValueError(f"loss_chunk {cfg.loss_chunk} does not "
                                     f"scale to seq {s}")
                c = replace(cfg, loss_chunk=cfg.loss_chunk * s
                            // shape.seq_len)
            return _round_cost(c, replace(shape, seq_len=s), n_clients, tau,
                               lr, n_mb)
        cost = _by_seq(shape.seq_len, at_seq)
    else:
        cost = _round_cost(cfg, shape, n_clients, tau, lr, n_mb)
    params1 = Transformer(cfg).init(device="meta")
    full = input_specs(cfg, shape, n_clients=n_clients, tau=tau)
    resident = {"params": n_clients * _bytes(params1),
                "optimizer": n_clients * _bytes(sgd(lr).init(params1)),
                "inputs": _bytes(full) + 4 * n_clients * (tau * n + 1),
                "caches": 0}
    tokens = shape.global_batch * shape.seq_len * tau
    return cost, n, tokens, n_mb, resident


def trace_prefill(cfg, shape):
    """Count ``prefill`` of the prompt batch (the caches it builds are
    part of its trace), extended to full depth by :func:`_by_depth`."""
    batch = input_specs(cfg, shape, dtype=_dtype(cfg))

    def count(c):
        model = Transformer(c)
        return cost_of(model.prefill, model.init(device="meta"),
                       batch["tokens"], batch.get("prefix"),
                       max_len=shape.seq_len)[0]

    params1 = Transformer(cfg).init(device="meta")
    resident = {"params": _bytes(params1), "optimizer": 0,
                "inputs": _bytes(batch), "caches": 0}
    return (_by_depth(cfg, count), param_count(params1),
            shape.global_batch * shape.seq_len, resident)


def trace_decode(cfg, shape):
    """Count one ``decode_step``: one new token per sequence against caches
    of ``seq_len`` (the last position), extended to full depth by
    :func:`_by_depth`."""
    b = shape.global_batch
    tokens = input_specs(cfg, shape)["tokens"]

    def count(c):
        model = Transformer(c)
        caches = model.init_cache(b, shape.seq_len, device="meta")
        return cost_of(model.decode_step, model.init(device="meta"), caches,
                       tokens, shape.seq_len - 1)[0]

    model = Transformer(cfg)
    params1 = model.init(device="meta")
    caches = model.init_cache(b, shape.seq_len, device="meta")
    resident = {"params": _bytes(params1), "optimizer": 0,
                "inputs": _bytes(tokens), "caches": _bytes(caches)}
    return _by_depth(cfg, count), param_count(params1), b, resident


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# run + report
# ---------------------------------------------------------------------------

OPTS = ("onehot_embed", "causal_buckets", "rwkv_chunk", "moe_dense")
# the JAX package's opts that only steer XLA's lowering and sharding
XLA_OPTS = ("scan_accum", "gather_weights", "ddp", "no_donate")


def apply_opts(cfg, opts: tuple[str, ...]):
    """Beyond-paper §Perf optimizations, applied on top of the baseline."""
    bad = [o for o in opts if o in XLA_OPTS]
    if bad:
        raise ValueError(f"--opt {','.join(bad)} only steers XLA's lowering "
                         f"of the JAX package; the port has nothing to "
                         f"steer (kept: {OPTS})")
    unknown = [o for o in opts if o not in OPTS]
    if unknown:
        raise ValueError(f"unknown --opt {unknown}; known: {OPTS}")
    kw = {}
    if "onehot_embed" in opts:
        kw["embed_impl"] = "one_hot"
    if "causal_buckets" in opts:
        kw["causal_buckets"] = True
    if "rwkv_chunk" in opts:
        kw["rwkv_chunk"] = 64
    if "moe_dense" in opts:
        kw["moe_impl"] = "dense"
    return replace(cfg, **kw) if kw else cfg


def run_one(arch: str, shape_name: str, n_clients: int | None = None,
            tau: int = 4, microbatches: int | None = None,
            opts: tuple[str, ...] = (), cfg=None, shape=None) -> dict:
    """The dry-run record of ``arch`` at ``shape_name`` on one card.
    ``cfg`` / ``shape`` override the registry's (a ``smoke_variant``, a
    cut shape)."""
    cfg = apply_opts(cfg or get_arch(arch), opts)
    shape = shape or get_shape(shape_name)
    ok, why = supports_shape(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "mesh": MESH,
                "status": "skipped", "reason": why}
    t0 = time.time()
    if shape.kind == "train":
        c = n_clients or 4
        cost, n_params, tokens, n_mb, resident = trace_train(
            cfg, shape, c, tau, microbatches=microbatches)
        extra = {"n_clients": c, "tau": tau, "microbatches": n_mb,
                 "opts": list(opts)}
    elif shape.kind == "prefill":
        cost, n_params, tokens, resident = trace_prefill(cfg, shape)
        extra = {}
    else:
        cost, n_params, tokens, resident = trace_decode(cfg, shape)
        extra = {"opts": list(opts)} if opts else {}
    live = sum(resident.values()) + cost.peak_live_bytes
    n_active = active_params(cfg, float(n_params))
    terms = RooflineTerms(
        flops=cost.flops, hbm_bytes=cost.hbm_bytes, coll_bytes=0.0,
        model_flops=model_flops_estimate(n_active, tokens, shape.kind),
        dtype=cfg.dtype)
    top = sorted(cost.by_op.items(), key=lambda kv: -kv[1]["bytes"])[:8]
    return {
        "arch": arch, "shape": shape.name, "mesh": MESH,
        "kind": shape.kind, "status": "traced",
        "n_params": n_params, "tokens_per_step": tokens,
        "trace_s": round(time.time() - t0, 2), **extra,
        "cost_analysis_raw": cost_analysis_dict(cost),
        "memory_analysis": {**{f"{k}_bytes": int(v)
                               for k, v in resident.items()},
                            "temp_peak_bytes": int(cost.peak_live_bytes)},
        "live_bytes_per_device": int(live),
        "fits_hbm": bool(live <= HBM_PER_CARD),
        "roofline": terms.as_dict(),
        "active_params": n_active,
        "kernels": {k[len("kernel:"):]: v for k, v in cost.by_op.items()
                    if k.startswith("kernel:")},
        "top_ops_by_bytes": {k: v for k, v in top},
    }


def bound_ms(rec: dict) -> float:
    """The least time, in ms, the card could take for a record's work: the
    larger of its compute and memory terms."""
    r = rec["roofline"]
    return max(r["t_compute_s"], r["t_memory_s"],
               r["t_collective_s"]) * 1e3


def _record(arch: str, shape: str, kw: dict) -> dict:
    """One combo's record; a failure is recorded, not raised."""
    try:
        return run_one(arch, shape, **kw)
    except Exception as e:  # noqa: BLE001 - record failures, keep going
        return {"arch": arch, "shape": shape, "status": "error",
                "mesh": MESH, "error": f"{type(e).__name__}: {e}"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="not ported: the JAX package's 2x16x16 mesh "
                         "(item 12)")
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--opt", default="",
                    help=f"comma list of §Perf optimizations: "
                         f"{','.join(OPTS)}")
    ap.add_argument("--tag", default="",
                    help="suffix for output json (e.g. _opt)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace this many combos at once, each in a "
                         "process of its own")
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise _not_ported("--multi-pod (a mesh of TPU pods)", "item 12")
    if not args.all and not (args.arch and args.shape):
        ap.error("pass --arch and --shape, or --all")

    os.makedirs(args.out_dir, exist_ok=True)
    combos = ([(a, s) for a in ASSIGNED_ARCHS for s in SHAPE_NAMES]
              if args.all else [(args.arch, args.shape)])
    kw = dict(n_clients=args.clients, tau=args.tau,
              microbatches=args.microbatches,
              opts=tuple(o for o in args.opt.split(",") if o))
    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        pool = ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn"))
        records = pool.map(_record, *zip(*combos), [kw] * len(combos))
    else:
        pool = None
        records = (_record(a, s, kw) for a, s in combos)
    results = []
    for (arch, shape), rec in zip(combos, records):
        tag = f"{arch}_{shape}_{MESH}" + args.tag
        print(f"=== dryrun {tag} ({rec.get('trace_s', 0.0)} s) ===",
              flush=True)
        results.append(rec)
        with open(os.path.join(args.out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=2)
        if rec.get("roofline"):
            r = rec["roofline"]
            print(f"  params={rec['n_params']/1e9:.2f}B "
                  f"flops={r['flops_per_device']/1e12:.2f}T "
                  f"bytes={r['hbm_bytes_per_device']/1e9:.2f}GB "
                  f"bound={bound_ms(rec):.3f}ms "
                  f"bottleneck={r['bottleneck']} "
                  f"useful={r['useful_flops_fraction']:.2%} "
                  f"live={rec['live_bytes_per_device']/2**30:.2f}GiB "
                  f"fits_hbm={rec['fits_hbm']}", flush=True)
        else:
            print(f"  {rec['status']}: "
                  f"{rec.get('reason', rec.get('error', ''))}", flush=True)
    if pool is not None:
        pool.shutdown()
    bad = [r for r in results if r["status"] == "error"]
    print(f"done: {len(results)} combos, {len(bad)} errors")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
