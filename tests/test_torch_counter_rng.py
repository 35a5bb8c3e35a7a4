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
* The wrapper's device rule: CPU tensors run the plain version, ``meta``
  counts ``cost`` and draws nothing, other devices and bad operands
  raise. On a card (``gpu`` marker) the kernel equals the plain version
  bit for bit and a slab draw equals its columns of the whole draw.
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


def test_odd_shapes_and_column_windows():
    """Leaves whose sizes and slices are not multiples of 4 (groups of
    four columns straddle leaves and slices), a leaf of no element, and
    the plain version's column windows (``lo``), through its general map
    and its one-run path for a whole row: all the whole draw's values."""
    shapes = ((3, 6, 5), (7,), (0, 4), (2, 10), (5,))
    flat = (1, -1, -1, 0, -1)
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
    params = Transformer(smoke_variant(get_arch("rwkv6-1.6b"))).init(
        device="meta")
    shapes, flat, _ = _shapes_dims(params, 2)
    n = sum(math.prod(s) for s in shapes)
    rows = torch.tensor([2, 0, 1], device=cuda_device)
    for table, width in ((crng.whole_table(n), n),
                         (crng.slab_table(shapes, flat, 1, 2),
                          _n_local(shapes, flat, 2))):
        t = torch.tensor(table, device=cuda_device)
        before = crng.counter_rng.launches
        got = crng.counter_rng(rows, t, 2, width, (7, 3), crng.NOISE,
                               normal)
        torch.cuda.synchronize()
        assert crng.counter_rng.launches == before + 1
        want = ref.counter_rng_ref(rows, t, 2, width, (7, 3), crng.NOISE,
                                   normal)
        assert torch.equal(got, want)
