"""Admission scheduler, serving clocks, and the static-batch baseline (a
port of the JAX package's ``serve/scheduler.py``).

:func:`serve_continuous` drives a :class:`SlotEngine` over an open-loop
workload: each loop iteration either admits a prefill group (requests
join at decode-step granularity — prefill is length-bucketed to bound
recompiles) or runs one decode wavefront; when the engine is empty and
nothing has arrived yet, the clock jumps to the next arrival (open-loop
semantics — arrivals never wait for the server).

Two clocks implement the :class:`ServeClock` protocol. ``WallClock``
advances by the measured host seconds of each unit of work and jumps
idle gaps instantly — real engine speed against simulated arrivals, the
benchmark configuration. ``StepClock`` charges fixed costs per decode
step / prefill token — fully deterministic, the test configuration (the
same role the zero-spread UniformLatency plays for the async engine).

:func:`serve_static` is the pre-engine baseline as a scheduler: FIFO
batches of same-length prompts, the whole batch decoded to its largest
generation budget (the convoy penalty), new arrivals wait for the batch
to drain. Greedy static and continuous serving emit the same tokens per
request (up to argmax ties within rounding); the benchmark measures what
the convoy + same-length grouping cost under mixed-length load.

Where the JAX package blocks on the device with ``jax.block_until_ready``,
the port calls ``torch.cuda.synchronize`` when the engine runs on a GPU.

On a serving mesh (:func:`repro_torch.launch.serve.serve_on_mesh`) every
rank runs the same loop, and each loop turn's collectives must be the
same on every rank: both drivers charge every rank the same work time, the
largest of the ranks' measured times (one all-reduce of one float over
the mesh per unit of work, :func:`_mesh_seconds`), so the ranks' clocks,
and the admissions, decode steps and swaps they decide, stay alike
whatever each rank's wall clock reads. The JAX package's engine runs on
one device and needs no such step.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models import sharding
from repro_torch.serve.requests import Request
from repro_torch.utils.tree import tree_leaves


class ServeClock:
    """Protocol: ``work(kind, wall_s, amount)`` charges one unit of
    server work (kind 'decode' | 'prefill'); ``jump(t)`` advances the
    idle clock to an arrival; ``now`` is simulated seconds."""

    now: float


@dataclass
class WallClock:
    """Simulated time = accumulated measured wall seconds of server work;
    idle gaps are skipped by jumping to the next arrival."""
    now: float = 0.0

    def work(self, kind: str, wall_s: float, amount: int = 1) -> None:
        self.now += wall_s

    def jump(self, t: float) -> None:
        self.now = max(self.now, t)


@dataclass
class StepClock:
    """Deterministic clock: every decode wavefront costs ``dt_decode``,
    prefill costs ``dt_prefill_token`` per padded prompt token."""
    dt_decode: float = 1.0
    dt_prefill_token: float = 0.125
    now: float = 0.0

    def work(self, kind: str, wall_s: float, amount: int = 1) -> None:
        if kind == "decode":
            self.now += self.dt_decode
        else:
            self.now += self.dt_prefill_token * amount

    def jump(self, t: float) -> None:
        self.now = max(self.now, t)


@dataclass
class ServeReport:
    """Everything the benchmark plots: completed requests (tokens +
    per-token emission times), aggregate tokens/s in simulated seconds,
    and backpressure stats sampled every loop iteration."""
    requests: list = field(default_factory=list)
    duration_s: float = 0.0
    tokens_out: int = 0
    queue_depth: list = field(default_factory=list)
    occupancy: list = field(default_factory=list)
    engine_stats: dict = field(default_factory=dict)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / self.duration_s if self.duration_s else 0.0

    def latencies(self) -> np.ndarray:
        if not self.requests:
            return np.zeros(0)
        return np.concatenate([r.token_latencies() for r in self.requests])

    def summary(self) -> dict:
        lat = self.latencies()
        # engine stats first: they are cumulative over the engine's whole
        # lifetime (warmup + every serve run on a reused engine), so the
        # per-run report fields must win on any shared key
        return {
            **self.engine_stats,
            "requests": len(self.requests),
            "tokens_out": self.tokens_out,
            "duration_s": round(self.duration_s, 4),
            "tokens_per_s": round(self.tokens_per_s, 2),
            "p50_latency_s": round(float(np.percentile(lat, 50)), 5)
            if lat.size else None,
            "p99_latency_s": round(float(np.percentile(lat, 99)), 5)
            if lat.size else None,
            "max_queue_depth": max(self.queue_depth, default=0),
            "occupancy_mean": round(float(np.mean(self.occupancy)), 3)
            if self.occupancy else 0.0,
        }


def _mesh_seconds(ctx, wall_s: float) -> float:
    """``wall_s``, one rank's measured seconds of a unit of work, as every
    rank of the serving mesh of the rules context ``ctx``
    (:func:`repro_torch.models.sharding.current_context`) charges it: the
    largest over the mesh's ranks, by one all-reduce (max) of one float
    over each mesh axis of more than one rank. ``wall_s`` as it is outside
    a mesh (no context, or a mesh of one rank)."""
    mesh = None if ctx is None else ctx[0]
    names = getattr(mesh, "mesh_dim_names", None)
    if not names or mesh.get_coordinate() is None:
        return wall_s
    import torch.distributed as dist
    t = torch.tensor([wall_s], dtype=torch.float64)
    for i, name in enumerate(names):
        if mesh.shape[i] > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX,
                            group=mesh.get_group(name))
    return float(t[0])


def _take_group(ready: deque, engine) -> list[Request]:
    """Head-of-line prefill group: the head request's bucket, plus every
    other ready request sharing it, up to free slots / prefill batch."""
    limit = min(engine.free_slots, engine.prefill_batch)
    head_bucket = engine.bucket_len(ready[0].prompt_len)
    group, keep = [], []
    for r in ready:
        if (len(group) < limit
                and engine.bucket_len(r.prompt_len) == head_bucket):
            group.append(r)
        else:
            keep.append(r)
    ready.clear()
    ready.extend(keep)
    return group


def serve_continuous(engine, workload: list[Request],
                     clock: ServeClock | None = None,
                     swap_at: float | None = None,
                     swap_params=None) -> ServeReport:
    """Run the engine over an arrival-ordered workload until every
    request completes. Admission has priority over decode (a free slot
    never idles while a bucketed group is ready). ``swap_at`` hot-swaps
    ``swap_params`` in at the first loop boundary past that simulated
    time — in-flight slots keep running. On a serving mesh (the engine's
    rules context) every rank charges the work times of
    :func:`_mesh_seconds`."""
    clock = clock or WallClock()
    ctx = getattr(engine, "rules_context", None)
    for r in workload:
        if r.prompt_len + r.max_gen > engine.max_len:
            raise ValueError(f"request {r.rid} needs {r.prompt_len}+"
                             f"{r.max_gen} tokens; engine max_len="
                             f"{engine.max_len}")
    pending = deque(sorted(workload, key=lambda r: (r.arrival, r.rid)))
    ready: deque[Request] = deque()
    report = ServeReport()
    t_start = clock.now
    swapped = swap_params is None

    while pending or ready or engine.n_active:
        if not swapped and clock.now >= swap_at:
            engine.swap_params(swap_params)
            swapped = True
        while pending and pending[0].arrival <= clock.now:
            ready.append(pending.popleft())
        report.queue_depth.append(len(ready))
        report.occupancy.append(engine.n_active / engine.n_slots)

        if ready and engine.free_slots:
            group = _take_group(ready, engine)
            bucket = engine.bucket_len(group[0].prompt_len)
            t0 = time.perf_counter()
            engine.admit(group)
            engine._sync()
            clock.work("prefill", _mesh_seconds(ctx, time.perf_counter()
                                                - t0),
                       amount=bucket * len(group))
        elif engine.n_active:
            t0 = time.perf_counter()
            emitted, finished = engine.step()
            clock.work("decode", _mesh_seconds(ctx,
                                               time.perf_counter() - t0))
            for r in emitted:
                r.emit_times.append(clock.now)
            for r in finished:
                r.finished = clock.now
                report.requests.append(r)
                report.tokens_out += len(r.out)
        elif pending:
            clock.jump(pending[0].arrival)
        else:  # pragma: no cover - loop condition excludes this
            break

    report.duration_s = clock.now - t_start
    report.engine_stats = engine.stats()
    report.requests.sort(key=lambda r: r.rid)
    return report


def serve_static(model, params, workload: list[Request],
                 clock: ServeClock | None = None, batch: int = 4,
                 temperature: float = 0.0, seed: int = 0,
                 max_len: int = 0) -> ServeReport:
    """Static-batch baseline: FIFO groups of same-prompt-length arrived
    requests (up to ``batch``), prefilled together and decoded to the
    group's largest generation budget; arrivals during a batch wait.
    Runs on ``params``' device with the model's ``prefill`` /
    ``decode_step`` and ``launch.serve.generate``'s sampler (a
    ``torch.multinomial`` draw from a generator seeded with ``seed``), so
    greedy tokens are the engine's. Inside a serving mesh's rules context
    every rank charges the work times of :func:`_mesh_seconds`."""
    from repro_torch.launch.serve import _sample

    clock = clock or WallClock()
    ctx = sharding.current_context()
    pending = deque(sorted(workload, key=lambda r: (r.arrival, r.rid)))
    report = ServeReport()
    t_start = clock.now
    span = max_len or max(r.prompt_len + r.max_gen for r in workload)
    device = tree_leaves(params)[0].device

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    while pending:
        if pending[0].arrival > clock.now:
            clock.jump(pending[0].arrival)
        head_len = pending[0].prompt_len
        group, keep = [], []
        for r in pending:
            if len(group) < batch and r.prompt_len == head_len \
                    and r.arrival <= clock.now:
                group.append(r)
            else:
                keep.append(r)
        pending = deque(keep)

        # pad the prefill batch to a fixed row count by repeating row 0,
        # so each distinct prompt length compiles exactly once
        toks = np.stack([r.tokens for r in group]
                        + [group[0].tokens] * (batch - len(group)))
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, caches, pos = model.prefill(
                params, torch.as_tensor(toks.astype(np.int64),
                                        device=device), max_len=span)
        sync()
        clock.work("prefill", _mesh_seconds(ctx, time.perf_counter() - t0),
                   amount=head_len * len(group))
        generator = torch.Generator(device=device).manual_seed(seed)
        gen = max(r.max_gen for r in group)  # convoy: all decode to max
        for i in range(gen):
            t0 = time.perf_counter()
            with torch.inference_mode():
                tok = _sample(logits, temperature, generator)
                logits, caches = model.decode_step(params, caches, tok,
                                                   pos + i)
            tok_np = tok.cpu().numpy()
            clock.work("decode", _mesh_seconds(ctx,
                                               time.perf_counter() - t0))
            for j, r in enumerate(group):
                if len(r.out) < r.max_gen:
                    r.out.append(int(tok_np[j]))
                    r.emit_times.append(clock.now)
        for r in group:
            r.finished = clock.now
            report.requests.append(r)
            report.tokens_out += len(r.out)
        report.queue_depth.append(len(pending))
        report.occupancy.append(len(group) / batch)

    report.duration_s = clock.now - t_start
    report.requests.sort(key=lambda r: r.rid)
    return report
