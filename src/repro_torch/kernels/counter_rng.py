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

On the card a draw is one launch. The kernel reads the column table
through a plan the host derives from it once (:func:`launch_plan`: per
leaf its divisions as multiply-highs and the strides of a thread's groups,
per tile of TILE columns its first leaf and whether it is aligned), kept
on the device beside the table, so a steady round uploads nothing.

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
import weakref

import numpy as np
import torch

from repro_torch.kernels.ref import counter_rng_ref
from repro_torch.utils.cost import counted

NOISE, MASK, AGG_RAND, SECURE = 0, 1, 2, 3   # purposes: the address' third
TABLE_COLS = 5          # (local start, whole offset, local span, whole span,
#                         shift) a leaf
_MAX_STEPS = 1 << 24    # steps share a counter word with the purpose
_MAX_PAIRS = 1 << 31    # (row, step) pairs a draw: the kernel counts in 32 bits
_U32 = (1 << 32) - 1
# The kernel's launch plan (csrc/counter_rng.cu, spelled alike there; a
# test holds the two alike): a tile of TILE local columns (256 threads x 4
# groups of 4), a thread's groups STRIDE local columns apart; PLAN_COLS
# int64 a leaf: (start, end, base = offset + shift, span_l, span_w, magic |
# shift << 32 | flags << 40 | drem << 48, 64-bit magic, step)
TILE = 4096
STRIDE = 1024
PLAN_COLS = 8
CONTIGUOUS, FAST32, ALIGNED = 1, 2, 4        # a leaf's flags
ALIGNED_TILE = 1 << 31                       # a tile entry's top bit
# the C entry's one argument: {out, rows, plan, tiles, rows, tau, n, seed,
# counter, purpose, normal, device, stream} as 13 int64
_ARGS = struct.Struct("<13q")
_LIB = None                          # the loaded library, once built
_RAW_STREAM = None                   # torch's current-stream handle getter
_PLANS: dict = {}       # id(table) -> (weakref, its _version, {n: plan})


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


def divmod_constants(d: int, bits: int = 32) -> tuple[int, int]:
    """(magic, shift) of the kernel's division by ``d`` (1 <= d <
    2^(bits - 1)) in ``bits``-bit words: ``x // d == mulhi(x, magic) >>
    shift`` for every 0 <= x < 2^(bits - 1), mulhi the high word of the
    2 ``bits``-bit product (magic = ceil(2^(bits - 1 + l) / d), l =
    ceil(log2 d), shift l - 1; the error magic d - 2^(bits - 1 + l) < d <=
    2^l keeps every such x's quotient exact). ``d`` 1 gives (0, 0): the
    kernel takes q = x."""
    if d == 1:
        return 0, 0
    lg = (d - 1).bit_length()
    return -(-(1 << (bits - 1 + lg)) // d), lg - 1


def plan_arrays(table, n: int):
    """The kernel's launch plan of column table ``table`` ((L, 5) of
    (local start, whole offset, local span, whole span, shift)) for rows
    of ``n`` local columns, in numpy: ``(leaves, tiles)``.

    ``leaves`` (L, PLAN_COLS) int64: each leaf's local columns [start,
    end) (end the next leaf's start, at least n for the last), its base
    offset + shift, span_l, span_w, a word of magic | shift << 32 | flags
    << 40 | drem << 48, the 64-bit magic (its bits; the shift is the same)
    and step: the division by span_l (:func:`divmod_constants`) in 32 bits
    where the leaf's columns and span_l fit in 31 bits (FAST32), else in
    64; STRIDE local columns on, (q, rem) moves by (dq, drem) =
    divmod(STRIDE, span_l) and the whole column by step = dq span_w +
    drem (and span_w - span_l more where rem wraps); flags CONTIGUOUS
    where span_l == span_w (whole column base + k - start, no division),
    ALIGNED where every group of four local columns (k % 4 == 0) it holds
    maps to one group of four whole columns: start and base multiples of
    4, the end a multiple of 4 or the row's, and span_l, span_w multiples
    of 4 unless contiguous. Leaves of no column count as aligned.

    ``tiles`` (ceil(n / TILE) + 1,) int32, None for one leaf (which holds
    every tile): entry t the leaf of tile t's first column, its top bit
    set where every leaf of the tile is aligned; the last entry the leaf
    of column n - 1, so entries t and t + 1 bound the leaves of tile t.
    The kernel reads a tile's entry only where the tile leaves the last
    leaf that held a whole tile."""
    t = np.asarray(table, dtype=np.int64).reshape(-1, TABLE_COLS)
    start, offset, span_l, span_w, shift = t.T
    if start[0] != 0 or np.any(np.diff(start) < 0):
        raise ValueError(f"a column table's local starts must begin at 0 "
                         f"and not decrease, got {start.tolist()}")
    end = np.maximum(np.append(start[1:], max(n, int(start[-1]))), start)
    used = (end > start) & (start < n)
    if np.any(used & ((span_l < 1) | (span_w < 0))):
        raise ValueError("a leaf holding columns needs span_l >= 1 and "
                         "span_w >= 0")
    base = offset + shift
    contiguous = span_l == span_w
    fast = used & ~contiguous & (end - start <= 1 << 31) & (span_l < 1 << 31)
    aligned = ~used | ((start % 4 == 0) & (base % 4 == 0)
                       & ((end % 4 == 0) | (end >= n))
                       & (contiguous | ((span_l % 4 == 0)
                                        & (span_w % 4 == 0))))
    flags = (contiguous * CONTIGUOUS + fast * FAST32
             + aligned * ALIGNED).astype(np.int64)
    dq, drem = np.divmod(STRIDE, np.maximum(span_l, 1))
    word, wide = flags << 40 | drem << 48, np.zeros_like(flags)
    for i in np.flatnonzero(used & ~contiguous):
        magic, sh = divmod_constants(int(span_l[i]), 64)
        wide[i] = magic - (1 << 64) if magic >> 63 else magic
        word[i] |= sh << 32 | (divmod_constants(int(span_l[i]))[0]
                               if fast[i] else 0)
    leaves = np.stack([start, end, base, span_l, span_w, word, wide,
                       dq * span_w + drem], axis=1)
    if len(t) == 1:
        return leaves, None
    n_tiles = -(-n // TILE)
    first_col = np.minimum(np.arange(n_tiles + 1, dtype=np.int64) * TILE,
                           n - 1)
    last_col = np.minimum(first_col[:n_tiles] + TILE, n) - 1
    first = np.searchsorted(start, first_col, side="right") - 1
    last = np.searchsorted(start, last_col, side="right") - 1
    odd = np.concatenate([[0], np.cumsum(~aligned)])
    whole = odd[last + 1] == odd[first[:n_tiles]]
    tiles = first.astype(np.int64)
    tiles[:n_tiles] |= whole.astype(np.int64) << 31
    return leaves, tiles.astype(np.uint32).view(np.int32)


def launch_plan(table, n: int):
    """:func:`plan_arrays` of the tensor ``table`` for rows of ``n``
    columns, on the table's device: ``(leaves, tiles or None)``. Built
    from the table's values at its first call (one read of the table to
    the host and one copy up), then kept while the table lives unwritten,
    so a steady round uploads nothing."""
    key = id(table)
    try:
        version = table._version
    except RuntimeError:            # an inference tensor counts no writes
        version = 0
    entry = _PLANS.get(key)
    if entry is None or entry[0]() is not table or entry[1] != version:
        entry = _PLANS[key] = (weakref.ref(
            table, lambda _, key=key: _PLANS.pop(key, None)), version, {})
    plan = entry[2].get(n)
    if plan is None:
        leaves, tiles = plan_arrays(table.tolist(), n)
        plan = entry[2][n] = (
            torch.from_numpy(leaves).to(table.device),
            None if tiles is None else torch.from_numpy(tiles).to(
                table.device))
    return plan


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
    if rows.shape[0] * tau >= _MAX_PAIRS:
        raise ValueError(f"a draw takes fewer than 2^31 (row, step) pairs, "
                         f"got {rows.shape[0]} x {tau}")
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
    leaves, tiles = launch_plan(table, n)
    out = torch.empty((r, tau, n), dtype=torch.float32, device=rows.device)
    seed &= (1 << 64) - 1
    err = lib.counter_rng_launch(_ARGS.pack(
        out.data_ptr(), rows.data_ptr(), leaves.data_ptr(),
        0 if tiles is None else tiles.data_ptr(), r, tau, n,
        seed - (1 << 64) if seed >> 63 else seed, counter, purpose,
        int(normal), dev, _RAW_STREAM(dev)))
    if err != 0:
        raise RuntimeError(f"counter_rng launch failed: "
                           f"{lib.counter_rng_error_string(err).decode()}")
    counter_rng.launches += 1
    return out


counter_rng.launches = 0
