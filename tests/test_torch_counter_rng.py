"""The port's counter-based generator (``repro_torch.kernels.counter_rng``:
Philox4x32-10 by address, Box-Muller in exactly rounded f32 ops).

* Philox4x32-10 against Random123's known-answer vectors, and the
  kernel's f32 constants against the plain version's table.
* Partitionable: a draw of any block of rows and of any model rank's
  slab of columns (``param_split_dims`` at dm 2 and 4, the local layout of
  ``split_order``) equals the same addresses of the whole draw, bit for
  bit, normals and uniforms; the slab tables map each local column to the
  whole column ``mesh.engine.local_noise`` takes (every transformer
  family's smoke params and the linear model); whole leaves' columns are
  alike on every model rank.
* Distributions: normals and uniforms by mean, variance and the
  Kolmogorov-Smirnov statistic, and no correlation between rows, steps,
  rounds (counters) or purposes.
* The kernel's launch plan (``counter_rng.plan_arrays``): a numpy model of
  the kernel's index walk (tile -> first-leaf table, the search within the
  tile's leaves, the 32-bit or 64-bit multiply-high division, a thread's
  later groups by stride increments, the aligned tiles' one group of four
  whole columns, the general path's column-by-column steps) reads
  ``counter_columns_ref``'s column for every local column of every
  family's slab tables, the linear model's, odd tables and spans at and
  above 2^31; the plan is built once a table. The kernel's rewritten
  normal transform, emulated op for op, equals the plain version at every
  24-bit word.
* The wrapper's device rule: CPU tensors run the plain version, ``meta``
  counts ``cost`` and draws nothing, other devices and bad operands
  raise. On a card (``gpu`` marker) the kernel equals the plain version
  bit for bit (aligned and general tiles, n % 4 != 0, tau > 1, rows not
  from 0, more than 65,535 pairs) and a slab draw equals its columns of
  the whole draw.
"""
import math
import re
from pathlib import Path

import _torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch
from scipy import stats

from repro_torch.configs import get_arch, smoke_variant
from repro_torch.kernels import counter_rng as crng
from repro_torch.kernels import ops, ref
from repro_torch.mesh.engine import local_noise
from repro_torch.models import linear as tlin
from repro_torch.models import sharding
from repro_torch.models.transformer import Transformer
from repro_torch.utils.cost import cost_of
from repro_torch.utils.tree import tree_flatten

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
        "kernels" / "csrc" / "counter_rng.cu")
ARCHS = ("gemma3-4b", "rwkv6-1.6b", "zamba2-7b", "phi3.5-moe-42b-a6.6b")


def _draw(rows, table, tau, n, key=(5, 2), purpose=crng.NOISE,
          normal=True):
    return crng.counter_rng(torch.tensor(rows, dtype=torch.int64),
                            torch.tensor(table, dtype=torch.int64), tau, n,
                            key, purpose, normal)


def _shapes_dims(params, dm):
    dims = sharding.param_split_dims(params, dm)
    return (tuple(tuple(x.shape) for x in tree_flatten(params)[0]),
            tuple(tree_flatten(dims)[0]), dims)


# ------------------------------- Philox --------------------------------------

@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))],
    ids=["zeros", "ones", "pi"])
def test_philox_known_answers(ctr, key, want):
    """Random123's philox4x32-10 known-answer vectors."""
    got = ref.philox4x32_ref(*(torch.tensor([c]) for c in ctr), *key)
    assert tuple(int(w) for w in got) == want


def test_kernel_constants_equal_the_plain_versions():
    """Every f32 constant of the transform is spelled with the same bit
    pattern in the CUDA source as in ``ref.RNG_CONSTANTS``, and each is its
    value rounded to f32."""
    src = CSRC.read_text()
    got = {m.group(1).lower(): int(m.group(2), 16) for m in re.finditer(
        r"#define RNG_(\w+) c\(0x([0-9A-Fa-f]+)u\)", src)}
    assert got == ref.RNG_CONSTANTS
    value = {"sqrt2": math.sqrt(2), "ln2": math.log(2), "pi_4": math.pi / 4,
             "s3": -1 / 6, "s5": 1 / 120, "s7": -1 / 5040,
             "s9": 1 / 362880, "c2": -0.5, "c4": 1 / 24, "c6": -1 / 720,
             "c8": 1 / 40320, "c10": -1 / 3628800,
             **{f"l{k}": 1 / k for k in (3, 5, 7, 9, 11, 13)}}
    for name, bits in ref.RNG_CONSTANTS.items():
        assert int(np.array(value[name], np.float32).view(np.uint32)) == bits


def test_uniform_and_normal_words():
    """A value is word column % 4 of the Philox call at (column // 4,
    purpose << 24 | step, row, counter), key (seed low, seed high): the
    uniform its top 24 bits times 2^-24, the normal Box-Muller on its
    word pair."""
    seed, counter, row, step, col = (1 << 40) + 9, 7, 3, 2, 10
    x = [int(w) for w in ref.philox4x32_ref(
        *(torch.tensor([v]) for v in (col // 4, (crng.AGG_RAND << 24) | step,
                                      row, counter)), seed & 0xFFFFFFFF,
        seed >> 32)]
    u = _draw([row], crng.whole_table(12), 3, 12, (seed, counter),
              crng.AGG_RAND, False)
    assert float(u[0, step, col]) == (x[col % 4] >> 8) * 2.0 ** -24
    xn = [int(w) for w in ref.philox4x32_ref(
        *(torch.tensor([v]) for v in (col // 4, step, row, counter)),
        seed & 0xFFFFFFFF, seed >> 32)]
    z = _draw([row], crng.whole_table(12), 3, 12, (seed, counter))
    u1 = ((xn[2] >> 8) + 1) * 2.0 ** -24
    u2 = (xn[3] >> 8) * 2.0 ** -24
    want = math.sqrt(-2 * math.log(u1)) * math.cos(2 * math.pi * u2)
    assert float(z[0, step, col]) == pytest.approx(want, abs=2e-6)


def test_transform_accuracy():
    """The series log and sine / cosine against float64 at 2^20 words: the
    log within 2e-7 relative, the sine and cosine within 2e-7."""
    x = torch.randint(0, 2 ** 32, (1 << 20,), dtype=torch.int64,
                      generator=torch.Generator().manual_seed(0))
    w = ref._neg2_log_uniform(x).double().numpy()
    u1 = ((x >> 8) + 1).double().numpy() * 2.0 ** -24
    exact = -2 * np.log(u1)
    assert np.max(np.abs(w - exact) / np.maximum(exact, 1e-30)) < 2e-7
    c, s = ref._sincos_2pi(x)
    u2 = (x >> 8).double().numpy() * 2.0 ** -24
    assert np.max(np.abs(c.double().numpy() - np.cos(2 * np.pi * u2))) < 2e-7
    assert np.max(np.abs(s.double().numpy() - np.sin(2 * np.pi * u2))) < 2e-7


def _kernel_transform(x):
    """csrc/counter_rng.cu's normal transform on uint32 words ``x``, op for
    op in numpy float32 (each IEEE-rounded as the kernel's ``__fmul_rn`` /
    ``__fadd_rn``; its div_rn and sqrt_rn correctly rounded): (-2 ln u with
    the range reduction in bits and the doublings folded into the
    constants, cos, sin with the octant's turn by sign-bit flips)."""
    f32 = np.float32
    c = {k: np.array(v, np.uint32).view(f32) for k, v in
         ref.RNG_CONSTANTS.items()}
    bits = ((x >> np.uint32(8)) + np.uint32(1)).astype(f32).view(np.uint32)
    mb = (bits & np.uint32(0x7FFFFF)) | np.uint32(0x3F800000)
    big = (mb > np.uint32(0x3FB504F3)).astype(np.uint32)
    m = (mb - (big << np.uint32(23))).view(f32)
    e = (bits >> np.uint32(23)).astype(np.int64) - 127 + big
    s = (m - f32(1)) / (m + f32(1))
    s2 = s * s
    p = c["l13"] * s2 + c["l11"]
    for k in ("l9", "l7", "l5", "l3"):
        p = p * s2 + c[k]
    w = s + s * (s2 * p)
    log = f32(-4) * w + (e - 24).astype(f32) * (f32(-2) * c["ln2"])
    t = x & np.uint32(0x1FFFFF00)
    g = np.where(x & np.uint32(0x20000000), np.uint32(0x20000000) - t,
                 t).astype(f32)
    theta = g * (np.array(0x31000000, np.uint32).view(f32) * c["pi_4"])
    z = theta * theta
    sp = c["s9"] * z + c["s7"]
    for k in ("s5", "s3"):
        sp = sp * z + c[k]
    sn = theta + (theta * z) * sp
    cp = c["c10"] * z + c["c8"]
    for k in ("c6", "c4", "c2"):
        cp = cp * z + c[k]
    cs = z * cp + f32(1)
    y = x ^ (x >> np.uint32(1))
    swap = (y & np.uint32(0x20000000)) != 0
    cos = np.where(swap, sn, cs).view(np.uint32) ^ (
        (y << np.uint32(1)) & np.uint32(0x80000000))
    sin = np.where(swap, cs, sn).view(np.uint32) ^ (x & np.uint32(0x80000000))
    return log, cos.view(f32), sin.view(f32)


def test_kernel_transform_equals_the_plain_version_for_every_word():
    """The kernel's rewrite of the normal transform (its exact refoldings:
    the log's halving in bits and doublings in the constants, theta in one
    multiply, the quadrant by sign bits) equals the plain version bit for
    bit at every 24-bit value a word's transform reads, and -2 ln u is +-0
    exactly where the kernel takes the square root's zero branch."""
    for lo in range(0, 1 << 24, 1 << 22):
        x = (np.arange(lo, lo + (1 << 22), dtype=np.uint32) << np.uint32(8))
        x |= np.uint32(0x5A)                 # low bits: read by no transform
        log, cos, sin = _kernel_transform(x)
        xt = torch.from_numpy(x.astype(np.int64))
        want_c, want_s = ref._sincos_2pi(xt)
        for got, want in ((log, ref._neg2_log_uniform(xt)), (cos, want_c),
                          (sin, want_s)):
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.numpy().view(np.uint32))
        np.testing.assert_array_equal(log == 0, x >= np.uint32(0xFFFFFF00))


# ---------------------------- partitionable ----------------------------------

@pytest.mark.parametrize("arch", ARCHS + ("linear",))
@pytest.mark.parametrize("dm", [2, 4])
def test_slab_tables_map_local_noise_columns(arch, dm):
    """Each model rank's column table sends local column k to the whole
    column ``local_noise`` puts there, for every leaf of the smoke params
    (and the linear model's); whole leaves' columns are alike on every
    rank and cover each whole leaf once."""
    params = (tlin.init_linear(104, device="meta") if arch == "linear" else
              Transformer(smoke_variant(get_arch(arch))).init(device="meta"))
    shapes, flat, dims = _shapes_dims(params, dm)
    n = sum(math.prod(s) for s in shapes)
    whole = torch.arange(n, dtype=torch.float64)[None]
    n_split = sum(math.prod(s) // dm for s, d in zip(shapes, flat) if d >= 0)
    heads, tails = [], []
    for index in range(dm):
        table = crng.slab_table(shapes, flat, index, dm)
        cols = ref.counter_columns_ref(table, 0, _n_local(shapes, flat, dm),
                                       "cpu")
        want = local_noise(whole, params, dims, index, dm)[0]
        assert torch.equal(cols, want.to(torch.int64))
        heads.append(cols[:n_split])
        tails.append(cols[n_split:])
    for t in tails[1:]:
        assert torch.equal(t, tails[0])
    # the ranks' split columns and the whole leaves' cover each column once
    every = torch.cat(heads + tails[:1]).sort().values
    assert torch.equal(every, torch.arange(n))


def _n_local(shapes, flat, dm):
    return sum(math.prod(s) // (dm if d >= 0 else 1)
               for s, d in zip(shapes, flat))


@pytest.mark.parametrize("normal", [True, False], ids=["normal", "uniform"])
@pytest.mark.parametrize("dm", [2, 4])
def test_slab_draws_equal_the_whole_draw_bitwise(dm, normal):
    """rwkv6-1.6b's smoke params (N 806,144) and an odd tree: every block
    of rows (pad rows reading client 0) and every model rank's slab equal
    the same addresses of the whole (C, tau, N) draw, bit for bit."""
    params = Transformer(smoke_variant(get_arch("rwkv6-1.6b"))).init(
        device="meta")
    shapes, flat, dims = _shapes_dims(params, dm)
    n = sum(math.prod(s) for s in shapes)
    key, c = (2 ** 33 + 17, 5), 3
    whole = _draw(tuple(range(c)), crng.whole_table(n), 2, n, key,
                  normal=normal)
    for index in range(dm):
        rows = (2, 0) if index % 2 else (1, 2, 0)
        table = crng.slab_table(shapes, flat, index, dm)
        got = _draw(rows, table, 2, _n_local(shapes, flat, dm), key,
                    normal=normal)
        want = local_noise(whole[list(rows)], params, dims, index, dm)
        assert got.shape == want.shape
        assert torch.equal(got, want)


ODD_SHAPES = ((3, 6, 5), (7,), (0, 4), (2, 10), (5,))
ODD_DIMS = (1, -1, -1, 0, -1)


def test_odd_shapes_and_column_windows():
    """Leaves whose sizes and slices are not multiples of 4 (groups of
    four columns straddle leaves and slices), a leaf of no element, and
    the plain version's column windows (``lo``), through its general map
    and its one-run path for a whole row: all the whole draw's values."""
    shapes, flat = ODD_SHAPES, ODD_DIMS
    n = sum(math.prod(s) for s in shapes)
    whole = _draw((0, 1, 2, 3), crng.whole_table(n), 3, n)
    tree = {f"l{i}": torch.empty(s, device="meta")
            for i, s in enumerate(shapes)}
    dims = {f"l{i}": d for i, d in enumerate(flat)}
    for dm in (2,):
        for index in range(dm):
            table = crng.slab_table(shapes, flat, index, dm)
            n_local = _n_local(shapes, flat, dm)
            got = _draw((3, 1), table, 3, n_local)
            want = local_noise(whole[[3, 1]], tree, dims, index, dm)
            assert torch.equal(got, want)
            for lo in (0, 3, 9):
                win = ref.counter_rng_ref(torch.tensor([3, 1]), table, 3,
                                          n_local - lo - 2, (5, 2),
                                          crng.NOISE, True, lo=lo)
                assert torch.equal(win, got[..., lo:n_local - 2])
    # a whole row's one-run path against the general map, in windows
    two = ((0, 0, 50, 50, 0), (50, 50, n - 50, n - 50, 0))
    for lo in (0, 1, 7):
        for table in (crng.whole_table(n), two):
            win = ref.counter_rng_ref(torch.tensor([0, 2]), table, 3,
                                      n - lo - 3, (5, 2), crng.NOISE, True,
                                      lo=lo)
            assert win.is_contiguous()
            assert torch.equal(win, whole[[0, 2], :, lo:n - 3])


# ------------------------------ launch plan ----------------------------------

def _kernel_columns(table, n: int, lo: int = 0, width: int | None = None):
    """A model of the kernel's index walk (csrc/counter_rng.cu) over the
    launch plan of ``table``: the whole column it reads for each local
    column in [lo, lo + width) (lo a multiple of 4), and the share of
    those columns in aligned tiles. Per group of four local columns: the
    tile's leaves from the tile table (the first alone where the tile ends
    inside it), the leaf of the group's first column by the kernel's binary
    search within them, (q, rem) by the 32-bit or 64-bit multiply-high
    (FAST32 or not) or none (CONTIGUOUS). In an aligned tile the four words
    of that column's whole group; where the tile lies in one leaf, a
    thread's first group (the tile's first STRIDE columns) by the division
    and each later one STRIDE columns on by adds (step, drem, the wrap). In
    any other tile the next columns by one step each (rem + 1, wrapping
    into q; the next leaf's first column at q = rem = 0)."""
    width = n - lo if width is None else width
    leaves, tiles = crng.plan_arrays(table, n)
    start, end, base, span_l, span_w, word, wide, step = leaves.T
    magic, shift = word & 0xFFFFFFFF, (word >> 32) & 0xFF
    flags, drem = (word >> 40) & 0xFF, word >> 48
    k = np.arange(lo, min(lo + width, n), 4, dtype=np.int64)
    tile = k // crng.TILE
    if tiles is None:
        lo_leaf = hi_leaf = np.zeros_like(k)
        aligned = np.full(k.shape, bool(flags[0] & crng.ALIGNED))
    else:
        entry = tiles.view(np.uint32).astype(np.int64)
        lo_leaf = entry[tile] & ~crng.ALIGNED_TILE
        hi_leaf = entry[tile + 1] & ~crng.ALIGNED_TILE
        aligned = (entry[tile] & crng.ALIGNED_TILE) != 0
    one = np.minimum((tile + 1) * crng.TILE, n) <= end[lo_leaf]
    hi_leaf = np.where(one, lo_leaf, hi_leaf)
    a, b = lo_leaf.copy(), hi_leaf.copy()
    while np.any(a < b):
        go = a < b
        mid = (a + b + 1) >> 1
        below = start[mid] <= k
        a, b = np.where(go & below, mid, a), np.where(go & ~below, mid - 1, b)

    def split(leaf, d):
        f = flags[leaf]
        q = np.where(magic[leaf] == 0, d, ((d.astype(np.uint64)
                     * magic[leaf].astype(np.uint64)) >> np.uint64(32))
                     .astype(np.int64) >> shift[leaf])
        q = np.where(f & crng.CONTIGUOUS, 0, q)
        for i in np.flatnonzero((f & (crng.CONTIGUOUS | crng.FAST32)) == 0):
            m = int(wide[leaf[i]]) % (1 << 64)  # the 64-bit multiply-high
            q[i] = d[i] if m == 0 else (int(d[i]) * m >> 64) >> int(
                shift[leaf[i]])
        return q, d - q * span_l[leaf]

    leaf = a
    q, rem = split(leaf, k - start[leaf])
    col0 = base[leaf] + q * span_w[leaf] + rem
    # a thread's groups in a one-leaf tile: its first by the division, then
    # STRIDE on by adds
    j = (k - tile * crng.TILE) // crng.STRIDE
    q1, rem1 = split(lo_leaf, k - j * crng.STRIDE - start[lo_leaf])
    col1 = base[lo_leaf] + q1 * span_w[lo_leaf] + rem1
    for s_ in range(1, crng.TILE // crng.STRIDE):
        go = j >= s_
        col1 = col1 + go * step[lo_leaf]
        rem1 = rem1 + go * drem[lo_leaf]
        wrap = go & (rem1 >= span_l[lo_leaf])
        rem1 = rem1 - wrap * span_l[lo_leaf]
        col1 = col1 + wrap * (span_w[lo_leaf] - span_l[lo_leaf])
    first = np.where(one, col1, col0)
    cols = [col0]
    for e in range(1, 4):
        ke = k + e
        move = (ke >= end[leaf]) & (ke < n)
        walk = move.copy()
        while np.any(walk):
            leaf = np.where(walk, leaf + 1, leaf)
            walk &= ke >= end[np.minimum(leaf, len(end) - 1)]
        rem = np.where(move, 0, rem + 1)
        wrap = ~move & (rem == span_l[leaf])
        q = np.where(move, 0, q + wrap)
        rem = np.where(wrap, 0, rem)
        cols.append(base[leaf] + q * span_w[leaf] + rem)
    general = np.stack(cols, axis=1)
    whole_group = (first >> 2 << 2)[:, None] + np.arange(4)
    got = np.where(aligned[:, None], whole_group, general).reshape(-1)
    return got[:min(width, n - lo)], float(aligned.mean())


def _plan_matches(table, n, lo=0, width=None):
    got, share = _kernel_columns(table, n, lo, width)
    want = ref.counter_columns_ref(table, lo, got.shape[0], "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    return share


@pytest.mark.parametrize("arch", ARCHS + ("linear",))
@pytest.mark.parametrize("dm", [2, 4])
def test_kernel_plan_reads_every_slab_column(arch, dm):
    """Every model rank's slab table of the smoke params (and the linear
    model's): the kernel's index walk reads ``counter_columns_ref``'s
    column for every local column, and so does the whole table's."""
    params = (tlin.init_linear(104, device="meta") if arch == "linear" else
              Transformer(smoke_variant(get_arch(arch))).init(device="meta"))
    shapes, flat, _ = _shapes_dims(params, dm)
    n_local = _n_local(shapes, flat, dm)
    for index in range(dm):
        _plan_matches(crng.slab_table(shapes, flat, index, dm), n_local)
    n = sum(math.prod(s) for s in shapes)
    assert _plan_matches(crng.whole_table(n), n) == 1.0


def test_kernel_plan_on_odd_tables():
    """Leaves whose sizes and slices are not multiples of 4 (a leaf
    boundary inside a group of four), a leaf of no element, whole tables
    with n % 4 != 0, split spans of one column and tables longer than one
    tile whose tiles are partly aligned: every local column read right,
    both paths taken."""
    for index in range(2):
        table = crng.slab_table(ODD_SHAPES, ODD_DIMS, index, 2)
        assert _plan_matches(table, _n_local(ODD_SHAPES, ODD_DIMS, 2)) == 0.0
    for n in (1, 3, 5, 2047, 2049, 4097):
        assert _plan_matches(crng.whole_table(n), n) == 1.0
    shapes = ((64, 6), (4096, 8), (6,), (14, 640), (3002, 4))
    shares = []
    for dims in ((1, 0, -1, 1, 0), (0, 1, -1, 0, 1), (-1, 0, 0, -1, 1)):
        for index in range(2):
            table = crng.slab_table(shapes, dims, index, 2)
            shares.append(_plan_matches(table, _n_local(shapes, dims, 2)))
    assert min(shares) < 1.0 and max(shares) > 0.0
    # one-leaf tiles of split leaves whose runs (500, 1,000 columns) do not
    # divide STRIDE: a thread's later groups wrap from run to run
    for shapes, dims in ((((64, 1000),), (1,)),
                         (((8,), (300, 1000), (4, 8)), (-1, 1, 0))):
        for index in range(2):
            table = crng.slab_table(shapes, dims, index, 2)
            assert _plan_matches(table, _n_local(shapes, dims, 2)) == 1.0


def test_kernel_plan_spans_past_31_bits():
    """Spans at and above 2^31 take the 64-bit multiply-high (no FAST32
    flag): windows around each leaf's wraps and boundaries read right;
    the 64-bit constants divide exactly at the ends of their range."""
    big = 1 << 31
    a_span = big + 12                        # span_l >= 2^31
    b_start = 2 * a_span
    c_start = b_start + 3 * (big // 2)       # leaf B: span_l < 2^31, but
    n = c_start + 100                        # its columns run past 2^31
    table = ((0, 0, a_span, 2 * big, 4),
             (b_start, 5 * big, big // 2, big, 8),
             (c_start, 7 * big, 6, 6, 0))
    leaves, tiles = crng.plan_arrays(table, n)
    flags = leaves[:, 5] >> 40
    assert not flags[0] & crng.FAST32 and not flags[1] & crng.FAST32
    assert flags[2] & crng.CONTIGUOUS
    for lo in (0, a_span - 8, b_start - 8, b_start + big // 2 - 8,
               b_start + big - 4, c_start - 12, n - 52):
        _plan_matches(table, n, lo - lo % 4, 64)
    fast = crng.plan_arrays(((0, 0, 3, 7, 1), (big - 3, 9, 5, 5, 0)),
                            big + 2)[0]
    assert (fast[0, 5] >> 40) & crng.FAST32
    _plan_matches(((0, 0, 3, 7, 1), (big - 3, 9, 5, 5, 0)), big + 2,
                  big - 16, 32)
    for d in (2, 3, 7, big - 1, big + 12, 3 << 40, (1 << 62) + 5,
              (1 << 63) - 1):
        for bits in (32, 64):
            if d >= 1 << (bits - 1):
                continue
            magic, sh = crng.divmod_constants(d, bits)
            assert magic < 1 << bits
            for x in (0, d - 1, d, 5 * d + 3, (1 << (bits - 1)) - 1):
                if x < 1 << (bits - 1):
                    assert (x * magic >> bits) >> sh == x // d


def test_plan_constants_equal_the_kernels():
    """The tile, the plan's record and its flags as the CUDA source spells
    them."""
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (0x[0-9A-Fa-f]+|\d+)u?[;,]",
                             src).group(1), 0)
    assert 4 * const("kThreads") * const("kGroups") == crng.TILE
    assert 4 * const("kThreads") == crng.STRIDE
    assert const("kPlanCols") == crng.PLAN_COLS
    assert (const("kContiguous"), const("kFast32"), const("kAligned")) == (
        crng.CONTIGUOUS, crng.FAST32, crng.ALIGNED)
    assert const("kAlignedTile") == crng.ALIGNED_TILE


def test_launch_plan_is_built_once_a_table():
    """The plan of a table tensor is built at its first draw and kept: a
    second call returns the same tensors (nothing uploaded); another n
    builds its own; writing the table rebuilds it; a bad table raises."""
    table = torch.tensor(crng.slab_table(ODD_SHAPES, ODD_DIMS, 1, 2))
    first = crng.launch_plan(table, 70)
    again = crng.launch_plan(table, 70)
    assert all(a is b for a, b in zip(first, again))
    assert crng.launch_plan(table, 71)[0] is not first[0]
    table[0, 1] = 0
    assert crng.launch_plan(table, 70)[0] is not first[0]
    one = torch.tensor(crng.whole_table(9))
    leaves, tiles = crng.launch_plan(one, 9)
    assert tiles is None and leaves.shape == (1, crng.PLAN_COLS)
    for bad in (((1, 0, 4, 4, 0),), ((0, 0, 4, 4, 0), (8, 0, 4, 4, 0),
                                      (4, 0, 4, 4, 0)),
                ((0, 0, 0, 4, 0),)):
        with pytest.raises(ValueError):
            crng.plan_arrays(bad, 12)


def test_keys_advance_and_seeds_split_into_two_words():
    key = crng.make_key(2 ** 40 + 3)
    assert key.dtype == torch.int64 and key.tolist() == [2 ** 40 + 3, 0]
    assert crng.next_key(key).tolist() == [2 ** 40 + 3, 1]
    assert crng.key_parts((4, 9)) == (4, 9)
    a = _draw((0,), crng.whole_table(64), 1, 64, (2 ** 40 + 3, 0))
    b = _draw((0,), crng.whole_table(64), 1, 64, (3, 0))
    assert not torch.equal(a, b)


# ---------------------------- distributions ----------------------------------

def test_normals_and_uniforms_are_distributed():
    """2^20 normals: mean within 5e-3, variance within 1%, KS statistic
    under 3e-3 (p ~ 1e-7 at 1.36 / sqrt(n) scale ~ 1.3e-3); 2^20
    uniforms: mean 1/2 and variance 1/12 likewise, KS against U[0, 1)."""
    n = 1 << 18
    z = _draw((0, 1), crng.whole_table(n), 2, n).reshape(-1).double()
    assert abs(float(z.mean())) < 5e-3
    assert float(z.var()) == pytest.approx(1.0, rel=1e-2)
    assert stats.kstest(z.numpy(), "norm").statistic < 3e-3
    assert float(z.abs().max()) < 5.8       # u1 >= 2^-24
    u = _draw((0, 1), crng.whole_table(n), 2, n, purpose=crng.AGG_RAND,
              normal=False).reshape(-1).double()
    assert float(u.min()) >= 0 and float(u.max()) < 1
    assert abs(float(u.mean()) - 0.5) < 3e-3
    assert float(u.var()) == pytest.approx(1 / 12, rel=1e-2)
    assert stats.kstest(u.numpy(), "uniform").statistic < 3e-3


def test_no_correlation_between_rows_steps_rounds_and_purposes():
    """Pairs of streams that differ in one address field: row, step,
    counter (the round), purpose, and the neighbouring column; each
    correlation under 5 / sqrt(n)."""
    n = 1 << 16
    t = crng.whole_table(n)
    base = _draw((3,), t, 2, n, (9, 4))
    pairs = {
        "row": _draw((4,), t, 2, n, (9, 4))[0, 0],
        "step": base[0, 1],
        "round": _draw((3,), t, 2, n, (9, 5))[0, 0],
        "purpose": _draw((3,), t, 2, n, (9, 4), crng.AGG_RAND)[0, 0],
        "seed": _draw((3,), t, 2, n, (10, 4))[0, 0],
        "column": torch.roll(base[0, 0], 1)}
    x = base[0, 0].double().numpy()
    for name, other in pairs.items():
        r = np.corrcoef(x, other.double().numpy())[0, 1]
        assert abs(r) < 5 / math.sqrt(n), (name, r)


# ----------------------------- the wrapper -----------------------------------

def test_device_rule_meta_cost_and_refusals():
    rows, table = torch.arange(3), torch.tensor(crng.whole_table(10))
    cpu = crng.counter_rng(rows, table, 2, 10, (1, 0), crng.NOISE)
    assert cpu.shape == (3, 2, 10) and cpu.dtype == torch.float32
    assert crng.counter_rng.launches == 0      # the plain version ran
    cost, out = cost_of(crng.counter_rng, rows.to("meta"),
                        table.to("meta"), 2, 10, (1, 0), crng.NOISE)
    assert out.device.type == "meta" and out.shape == (3, 2, 10)
    assert cost.kernel_calls("counter_rng") == 1
    assert cost.hbm_bytes == crng.cost(3, 2, 10, True)[1]
    assert crng.operations(3, 2, 10, True) == (80 * 18, 94 * 18)
    for bad in (dict(rows=rows.to(torch.int32)), dict(rows=rows[:0]),
                dict(table=table[:, :4]), dict(tau=0),
                dict(tau=1 << 24), dict(n=0), dict(purpose=256),
                dict(key=(1, 1 << 32))):
        args = dict(rows=rows, table=table, tau=2, n=10, key=(1, 0),
                    purpose=crng.NOISE)
        args.update(bad)
        with pytest.raises(ValueError):
            crng.counter_rng(**args)


def test_counter_draw_uploads_its_operands_once():
    """The row ids and the column table go to the device once and are
    reused by every later draw of the same (rows, table, device)."""
    from repro_torch.utils import device as udev
    a = ops.counter_draw((1, 0), (0, 1), crng.whole_table(8), 1, 8,
                         crng.NOISE, True, "cpu")
    rows = udev.device_constant((0, 1), "cpu")
    table = udev.device_constant(crng.whole_table(8), "cpu")
    b = ops.counter_draw((1, 0), (0, 1), crng.whole_table(8), 1, 8,
                         crng.NOISE, True, "cpu")
    assert udev.device_constant((0, 1), "cpu") is rows
    assert udev.device_constant(crng.whole_table(8), "cpu") is table
    assert torch.equal(a, b)


# ------------------------------ on the card ----------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernel has no CPU "
                    "mode (its plain version is tested above)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("normal", [True, False], ids=["normal", "uniform"])
def test_cuda_kernel_equals_plain_version_bitwise(cuda_device, normal):
    """One launch a draw, bit for bit the plain version: rwkv6-1.6b's
    smoke params whole and as rank 1's slab (tau 2), an aligned whole
    table with n % 4 != 0, the odd slab table (a leaf boundary inside a
    group of four; general tiles only), a table of aligned and general
    tiles and a split leaf whose runs do not divide a thread's stride (its
    later groups' columns by adds that wrap), at rows that do not start at
    0 (tau 2 and 3)."""
    params = Transformer(smoke_variant(get_arch("rwkv6-1.6b"))).init(
        device="meta")
    shapes, flat, _ = _shapes_dims(params, 2)
    n = sum(math.prod(s) for s in shapes)
    mixed = ((64, 6), (4096, 8), (6,), (14, 640), (3002, 4))
    mixed_dims = (1, 0, -1, 1, 0)
    cases = [((2, 0, 1), 2, crng.whole_table(n), n),
             ((2, 0, 1), 2, crng.slab_table(shapes, flat, 1, 2),
              _n_local(shapes, flat, 2)),
             ((5, 3, 9), 3, crng.whole_table(10_001), 10_001),
             ((7, 1), 3, crng.slab_table(ODD_SHAPES, ODD_DIMS, 1, 2),
              _n_local(ODD_SHAPES, ODD_DIMS, 2)),
             ((4, 6), 3, crng.slab_table(mixed, mixed_dims, 0, 2),
              _n_local(mixed, mixed_dims, 2)),
             ((9, 2), 2, crng.slab_table(((64, 1000),), (1,), 1, 2),
              32_000)]
    for row_ids, tau, table, width in cases:
        rows = torch.tensor(row_ids, device=cuda_device)
        t = torch.tensor(table, device=cuda_device)
        before = crng.counter_rng.launches
        got = crng.counter_rng(rows, t, tau, width, (7, 3), crng.NOISE,
                               normal)
        torch.cuda.synchronize()
        assert crng.counter_rng.launches == before + 1
        want = ref.counter_rng_ref(rows, t, tau, width, (7, 3), crng.NOISE,
                                   normal)
        assert torch.equal(got, want), (row_ids, tau, width)


@pytest.mark.gpu
@pytest.mark.parametrize("normal", [True, False], ids=["normal", "uniform"])
def test_cuda_kernel_past_65535_pairs_and_slabs_of_the_whole_draw(
        cuda_device, normal):
    """(70,000, 1, 3) and (40,000, 2, 5) draws (more (row, step) pairs than
    a grid's y dimension holds) bit for bit the plain version; every model
    rank's slab of rwkv6-1.6b's smoke params at dm 2 and 4 and of the odd
    tree bit for bit its columns of the whole draw on the card."""
    for rows_n, tau, n in ((70_000, 1, 3), (40_000, 2, 5)):
        rows = torch.arange(11, 11 + rows_n, device=cuda_device)
        t = torch.tensor(crng.whole_table(n), device=cuda_device)
        got = crng.counter_rng(rows, t, tau, n, (2 ** 40 + 1, 9),
                               crng.AGG_RAND, normal)
        want = ref.counter_rng_ref(rows, t, tau, n, (2 ** 40 + 1, 9),
                                   crng.AGG_RAND, normal)
        assert torch.equal(got, want), (rows_n, tau, n)
    params = Transformer(smoke_variant(get_arch("rwkv6-1.6b"))).init(
        device="meta")
    tree = {f"l{i}": torch.empty(s, device="meta")
            for i, s in enumerate(ODD_SHAPES)}
    cases = [(params, dm, *_shapes_dims(params, dm)) for dm in (2, 4)]
    cases.append((tree, 2, ODD_SHAPES, ODD_DIMS,
                  {f"l{i}": d for i, d in enumerate(ODD_DIMS)}))
    for tree_, dm, shapes, flat, dims in cases:
        n = sum(math.prod(s) for s in shapes)
        whole = crng.counter_rng(
            torch.arange(3, device=cuda_device),
            torch.tensor(crng.whole_table(n), device=cuda_device), 2, n,
            (5, 2), crng.NOISE, normal)
        for index in range(dm):
            rows = (2, 0) if index % 2 else (1, 2, 0)
            got = crng.counter_rng(
                torch.tensor(rows, device=cuda_device),
                torch.tensor(crng.slab_table(shapes, flat, index, dm),
                             device=cuda_device), 2,
                _n_local(shapes, flat, dm), (5, 2), crng.NOISE, normal)
            want = local_noise(whole[list(rows)], tree_, dims, index, dm)
            assert torch.equal(got, want), (dm, index)
