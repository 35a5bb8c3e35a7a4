"""Wrapper of the hand-written CUDA ``counter_rng`` kernel
(``csrc/counter_rng.cu``): uniforms and normals by address, from a
counter-based generator (Philox4x32-10). It replaces no Pallas kernel: the
JAX package's randomness is jax.random's threefry, whose values are
functions of their keys, and this is the port's counterpart.

A value's address is (seed, counter, purpose, row, step, column): the
key ``(seed, counter)`` of a federation (:func:`make_key`; each round's
draws take one counter, :func:`next_key`), what the value is for
(:data:`NOISE`, :data:`MASK`, :data:`AGG_RAND`), the client's global row,
the local step, and the column of the whole flat row (leaves end to end in
``jax.tree.flatten`` order). No value depends on the launch's shape, on
which rows are asked for or on which columns: a draw of a block of rows and
of a model slice's columns (through a per-leaf column table,
:func:`slab_table`) equals the same addresses of the whole draw
(:func:`whole_table`), bit for bit, on the card and on the CPU.

The tensor's device decides the route: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.counter_rng_ref`, and a ``meta`` tensor gets
an output of the right shape and no arithmetic. Any other device raises.
Nothing falls back. Under :func:`repro_torch.utils.cost.cost_of` a call
counts as :func:`cost`, whatever implements it.
"""
from __future__ import annotations

import ctypes
import math
import struct

import torch

from repro_torch.kernels.ref import counter_rng_ref
from repro_torch.utils.cost import counted

NOISE, MASK, AGG_RAND, SECURE = 0, 1, 2, 3   # purposes: the address' third
TABLE_COLS = 5          # (local start, whole offset, local span, whole span,
#                         shift) a leaf
_MAX_STEPS = 1 << 24    # steps share a counter word with the purpose
_U32 = (1 << 32) - 1
_GRID_BLOCKS = 2048     # CTAs a launch at most (over the (row, step) pairs)
_THREADS = 256
# the C entry's one argument: {out, rows, table, rows, tau, n, leaves,
# seed, counter, purpose, normal, grid.x, stream} as 13 int64
_ARGS = struct.Struct("<13q")
_LIB = None                          # the loaded library, once built
_RAW_STREAM = None                   # torch's current-stream handle getter


def make_key(seed: int) -> torch.Tensor:
    """A federation's first key: the (2,) int64 ``(seed, counter 0)`` on
    the CPU (the draws read it on the host; no device sync)."""
    return torch.tensor([int(seed), 0], dtype=torch.int64)


def key_parts(key) -> tuple[int, int]:
    """``(seed, counter)`` of a key tensor or pair."""
    seed, counter = (int(v) for v in (key.tolist() if isinstance(
        key, torch.Tensor) else key))
    return seed, counter


def next_key(key) -> torch.Tensor:
    """The key one draw later: the counter advanced by one."""
    seed, counter = key_parts(key)
    return torch.tensor([seed, counter + 1], dtype=torch.int64)


def whole_table(n: int) -> tuple:
    """The column table of a whole row of ``n`` columns: one leaf, each
    local column its own whole column."""
    return ((0, 0, n, n, 0),)


def slab_table(shapes, dims, index: int, dm: int) -> tuple:
    """The column table of model rank ``index`` of ``dm``'s slab of a flat
    row whose leaves (in ``jax.tree.flatten`` order) have the whole shapes
    ``shapes`` and split dims ``dims`` (-1 whole): leaves in the local
    layout of :func:`repro_torch.kernels.ops.split_order` (split leaves
    first), a split leaf's columns those of its slice along its dim, a
    whole leaf's all of them (the same on every model rank). Leaves of no
    element are left out."""
    from repro_torch.kernels.ops import split_order
    offsets, off = [], 0
    for shape in shapes:
        offsets.append(off)
        off += math.prod(shape)
    rows, start = [], 0
    for i in split_order(list(dims)):
        shape, d = tuple(shapes[i]), dims[i]
        numel = math.prod(shape)
        if numel == 0:
            continue
        if d < 0:
            span_l = span_w = numel
            shift = 0
        else:
            inner = math.prod(shape[d + 1:])
            per = shape[d] // dm
            span_l, span_w, shift = per * inner, shape[d] * inner, \
                index * per * inner
        rows.append((start, offsets[i], span_l, span_w, shift))
        start += numel // (dm if d >= 0 else 1)
    return tuple(rows)


def operations(rows: int, tau: int, n: int, normal: bool) -> tuple[int, int]:
    """(integer ops, f32 ops) of one draw of (rows, tau, n), counting one
    Philox call a group of four columns: 80 integer ops a call (ten rounds
    of two 32-bit multiplies, high and low, two three-way xors and two key
    adds); the normal transform ~94 f32 ops a call (two logs by series,
    two sine-cosine pairs, two square roots, four products), a uniform 2."""
    calls = rows * tau * -(-n // 4)
    return 80 * calls, (94 * calls if normal else 8 * calls)


def cost(rows: int, tau: int, n: int, normal: bool,
         leaves: int = 1) -> tuple[int, int]:
    """(flops, bytes) of one draw: the f32 ops of :func:`operations`; the
    output written once, the row ids and the column table read once."""
    return (operations(rows, tau, n, normal)[1],
            4 * rows * tau * n + 8 * rows + 8 * TABLE_COLS * leaves)


def _check(rows, table, tau, n, purpose):
    if (rows.dtype != torch.int64 or rows.dim() != 1 or rows.shape[0] == 0
            or not rows.is_contiguous()):
        raise ValueError(f"rows must be a contiguous non-empty (R,) int64 "
                         f"tensor, got {tuple(rows.shape)} {rows.dtype}")
    if (table.dtype != torch.int64 or table.dim() != 2
            or table.shape[1] != TABLE_COLS or table.shape[0] == 0
            or not table.is_contiguous() or table.device != rows.device):
        raise ValueError(f"table must be a contiguous (L, {TABLE_COLS}) "
                         f"int64 tensor on {rows.device}, got "
                         f"{tuple(table.shape)} {table.dtype} on "
                         f"{table.device}")
    if not (1 <= tau < _MAX_STEPS) or n < 1:
        raise ValueError(f"tau must be in [1, 2^24) and n positive, got "
                         f"tau {tau}, n {n}")
    if not 0 <= purpose < 256:
        raise ValueError(f"purpose must be in [0, 256), got {purpose}")


def counter_rng(rows, table, tau: int, n: int, key, purpose: int,
                normal: bool = True):
    """The (R, tau, n) f32 draw at rows ``rows`` ((R,) int64 global row
    ids), steps 0..tau-1 and the ``n`` local columns that ``table`` ((L,
    5) int64 on rows' device, :func:`whole_table` / :func:`slab_table`)
    maps to whole columns, of stream ``key`` ``(seed, counter)`` and
    ``purpose``: standard normals, or U[0, 1) uniforms with ``normal``
    False. On a CUDA tensor every call launches one kernel on the current
    stream and adds 1 to ``counter_rng.launches``; on a ``meta`` tensor it
    returns an empty output and draws nothing."""
    _check(rows, table, tau, n, purpose)
    seed, counter = key_parts(key)
    if not 0 <= counter <= _U32:
        raise ValueError(f"the key's counter must be in [0, 2^32), got "
                         f"{counter}")
    return counted(
        "counter_rng",
        lambda: cost(rows.shape[0], tau, n, normal, table.shape[0]),
        lambda: _run(rows, table, tau, n, seed, counter, purpose, normal))


def _library():
    global _LIB, _RAW_STREAM
    if _LIB is None:
        from repro_torch.kernels._build import load_library
        lib = load_library("counter_rng")
        lib.counter_rng_launch.argtypes = [ctypes.c_char_p]
        lib.counter_rng_launch.restype = ctypes.c_int
        lib.counter_rng_error_string.argtypes = [ctypes.c_int]
        lib.counter_rng_error_string.restype = ctypes.c_char_p
        _RAW_STREAM = torch._C._cuda_getCurrentRawStream
        _LIB = lib
    return _LIB


def _run(rows, table, tau, n, seed, counter, purpose, normal):
    r = rows.shape[0]
    if not rows.is_cuda:
        if rows.device.type == "cpu":
            return counter_rng_ref(rows, table, tau, n, (seed, counter),
                                   purpose, normal)
        if rows.device.type == "meta":
            return torch.empty((r, tau, n), dtype=torch.float32,
                               device="meta")
        raise ValueError(f"counter_rng runs on cuda, cpu or meta tensors, "
                         f"got {rows.device}")
    lib = _LIB or _library()
    dev = rows.get_device()
    if torch._C._cuda_getDevice() != dev:
        # a launch goes to the current device: make it the rows' (the
        # common single-device case never enters this context)
        with torch.cuda.device(dev):
            return _run(rows, table, tau, n, seed, counter, purpose, normal)
    out = torch.empty((r, tau, n), dtype=torch.float32, device=rows.device)
    pairs = min(r * tau, 65535)
    grid_x = max(1, min(-(-n // (4 * _THREADS)), _GRID_BLOCKS // pairs))
    seed &= (1 << 64) - 1
    err = lib.counter_rng_launch(_ARGS.pack(
        out.data_ptr(), rows.data_ptr(), table.data_ptr(), r, tau, n,
        table.shape[0], seed - (1 << 64) if seed >> 63 else seed, counter,
        purpose, int(normal), grid_x, _RAW_STREAM(dev)))
    if err != 0:
        raise RuntimeError(f"counter_rng launch failed: "
                           f"{lib.counter_rng_error_string(err).decode()}")
    counter_rng.launches += 1
    return out


counter_rng.launches = 0
