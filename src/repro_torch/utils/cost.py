"""Work counting: the flops, HBM bytes and live memory of a function, read
while it runs, typically on ``meta`` tensors (shapes only, nothing
allocated). The counterpart of the JAX package's ``repro/utils/hlo.py``,
which parses XLA's compiled HLO text: there is no HLO here, so
:func:`cost_of` counts the ATen ops the function dispatches.

- ``flops``: :class:`torch.utils.flop_counter.FlopCounterMode`'s count
  (matmuls, convolutions and attention; elementwise ops count 0, as in
  XLA's cost analysis of a dot-dominated program).
- ``hbm_bytes``: the bytes of every op's tensor operands and results (each
  op reads its operands once and writes its results once; views and
  allocations move nothing). No fusion is assumed, so this is what an
  eager run moves, an upper bound on a fused one.
- ``peak_live_bytes``: the peak of the storage allocated during the call
  that was alive at one time, followed through the tensors the ops return
  (the inputs' storage is not in it).
- ``by_op``: per op (``aten.mm``, ``kernel:flash_attention``, ...) its
  calls, flops and bytes.

**A hand kernel's work is counted the same whatever implements it.** Each
kernel wrapper (``repro_torch/kernels/<name>.py``) has a ``cost(...)``
giving ``(flops, bytes)`` of what the kernel does, and runs its body
through :func:`counted`: under an active counter the wrapper's own ops
(the plain version's arithmetic on the CPU, nothing on ``meta``) are left
out, and the kernel's ``cost`` is counted once per call. On a ``meta``
tensor a wrapper returns outputs of the right shapes and dtypes and runs
no arithmetic.

Not ported from ``hlo.py``: ``analyze_hlo``, ``collective_bytes``,
``count_ops`` and ``HloCostModel``'s text parsing, which read XLA's own
output.
"""
from __future__ import annotations

import copy
import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_ACTIVE: list["_Counter"] = []

# ops that move no bytes: allocation without a fill, and aliasing
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "detach", "alias",
               "lift_fresh", "set_", "resize_", "_unsafe_view"}


@dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    peak_live_bytes: int = 0
    by_op: dict = field(default_factory=dict)

    def kernel_calls(self, name: str) -> int:
        """Calls of hand kernel ``name`` counted in this cost."""
        return self.by_op.get(f"kernel:{name}", {}).get("calls", 0)


def cost_analysis_dict(cost: Cost) -> dict:
    """``cost`` under the keys of XLA's ``compiled.cost_analysis()`` (the
    JAX package's ``cost_analysis_dict``)."""
    return {"flops": float(cost.flops),
            "bytes accessed": float(cost.hbm_bytes)}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class _Counter(TorchDispatchMode):
    """Bytes and live storage of the ops below it; flops from the
    FlopCounterMode it sits in."""

    def __init__(self, flop_mode):
        super().__init__()
        self.flop_mode = flop_mode
        self.hbm_bytes = 0
        self.by_op: dict = defaultdict(lambda: {"calls": 0, "flops": 0.0,
                                                "bytes": 0})
        self.kernel_flops = 0.0
        self.suspended = 0
        self.live = 0
        self.peak = 0
        self._storages: dict[int, list] = {}     # key -> [bytes, tensors]
        self._external: dict[int, torch.Tensor] = {}

    # -- live storage ------------------------------------------------------
    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def _see_input(self, t: torch.Tensor) -> None:
        key = self._key(t)
        if key not in self._storages and key not in self._external:
            # held, so its address is not reused by a later allocation
            self._external[key] = t

    def _see_output(self, t: torch.Tensor) -> None:
        key = self._key(t)
        if key in self._external:
            return
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [t.untyped_storage().nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.suspended:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        for t in ins:
            self._see_input(t)
        for t in outs:
            self._see_output(t)
        name = func.overloadpacket.__name__
        if func.is_view or name in _NO_TRAFFIC:
            return out
        moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        rec = self.by_op[f"aten.{name}"]
        rec["calls"] += 1
        rec["bytes"] += moved
        self.hbm_bytes += moved
        return out

    def add_kernel(self, name: str, flops: float, nbytes: float,
                   out) -> None:
        rec = self.by_op[f"kernel:{name}"]
        rec["calls"] += 1
        rec["flops"] += float(flops)
        rec["bytes"] += int(nbytes)
        self.kernel_flops += float(flops)
        self.hbm_bytes += int(nbytes)
        for t in _tensors(out):
            self._see_output(t)


def counting() -> bool:
    """Is a :func:`cost_of` counter active (outside a kernel's body)?"""
    return bool(_ACTIVE) and not _ACTIVE[-1].suspended


def counted(name: str, work, run):
    """``run()``, the body of hand kernel ``name``'s wrapper. Under an
    active counter the ops ``run`` dispatches are left out and ``work()``
    (its ``(flops, bytes)``) is counted once instead, with ``run``'s
    outputs as a new allocation; otherwise ``run()`` alone."""
    if not counting():
        return run()
    counter = _ACTIVE[-1]
    saved = copy.deepcopy(counter.flop_mode.flop_counts)
    counter.suspended += 1
    try:
        out = run()
    finally:
        counter.suspended -= 1
        counter.flop_mode.flop_counts = saved
    flops, nbytes = work()
    counter.add_kernel(name, flops, nbytes, out)
    return out


def cost_of(fn, *args, **kwargs) -> tuple[Cost, object]:
    """Run ``fn(*args, **kwargs)`` and count its work; returns
    ``(Cost, fn's result)``. Pass ``meta`` tensors to count without
    computing or allocating anything."""
    from torch.utils.flop_counter import FlopCounterMode

    flop_mode = FlopCounterMode(display=False)
    counter = _Counter(flop_mode)
    with flop_mode:
        _ACTIVE.append(counter)
        try:
            with counter:
                result = fn(*args, **kwargs)
        finally:
            _ACTIVE.pop()
    by_op = {k: dict(v) for k, v in counter.by_op.items()}
    for packet, flops in flop_mode.get_flop_counts().get("Global",
                                                         {}).items():
        rec = by_op.setdefault(f"aten.{packet.__name__}",
                               {"calls": 0, "flops": 0.0, "bytes": 0})
        rec["flops"] = float(flops)
    cost = Cost(flops=float(flop_mode.get_total_flops())
                + counter.kernel_flops,
                hbm_bytes=float(counter.hbm_bytes),
                peak_live_bytes=int(counter.peak), by_op=by_op)
    return cost, result
