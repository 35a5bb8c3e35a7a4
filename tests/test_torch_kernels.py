"""The port's kernel modules (``dp_clip_noise``, ``quantize_decompress``,
``cohort_gather_scatter``, ``flash_attention``, ``rwkv6_scan``,
``mamba2_ssd``) against the JAX package.

On the CPU a wrapper runs its kernel's plain version, so here the plain
``dp_clip_noise`` is held against JAX's Pallas kernel (interpret mode) and
its jnp reference on the same numpy-seeded inputs, at atol 1e-6 (sums taken
in another order); the plain ``quantize_decompress`` is held bit for bit
against JAX in ``tests/test_torch_aggregation.py``; the plain
``cohort_gather_scatter`` bit for bit against JAX's reference and its Pallas
kernel (interpret mode) here; the plain ``flash_attention``, ``rwkv6_scan``
and ``mamba2_ssd`` against the Pallas kernels run directly in interpret mode
(``repro.kernels.ops`` goes through ``repro.kernels.dispatch``, which fails
on jax 0.9), JAX's jnp references and the JAX model's own baselines. The
hand-written CUDA
kernels themselves are held against their plain versions by the ``gpu``
tests at the end, which need a card:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

(``--noconftest`` because the suite's conftest imports jax, which a machine
that only runs the GPU tests need not have.)
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import zlib

import numpy as np
import pytest
import torch

try:        # the reference; absent where only the gpu tests run
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.cohort_gather import (
        cohort_gather_scatter as jax_cohort_gather_scatter,
    )
    from repro.kernels.dp_clip_noise import dp_clip_noise as jax_dp_clip_noise
    from repro.kernels.flash_attention import (
        flash_attention as jax_flash_attention,
    )
    from repro.kernels.mamba2_ssd import mamba2_ssd as jax_mamba2_ssd
    from repro.kernels.ops import dp_clip_noise_tree as jax_dp_clip_noise_tree
    from repro.kernels.rwkv6_scan import rwkv6_scan as jax_rwkv6_scan
    from repro.models.attention import blocked_causal_attention
    from repro.models.rwkv import wkv6_chunked as jax_wkv6_chunked
    from repro.models.rwkv import wkv6_scan as jax_wkv6_scan
    from repro.models.ssm import ssd_chunked as jax_ssd_chunked
except ModuleNotFoundError:
    jax = None

from repro_torch.kernels import ops
from repro_torch.kernels.cohort_gather_scatter import cohort_gather_scatter
from repro_torch.kernels.dp_clip_noise import dp_clip_noise
from repro_torch.kernels.flash_attention import _variant, flash_attention
from repro_torch.kernels.mamba2_ssd import _variant as _ssd_variant
from repro_torch.kernels.mamba2_ssd import mamba2_ssd
from repro_torch.kernels.ops import (
    cohort_gather,
    cohort_scatter,
    dp_clip_noise_tree,
    quantize_decompress_rows,
)
from repro_torch.kernels.quantize_decompress import quantize_decompress
from repro_torch.kernels.ref import (
    cohort_gather_scatter_ref,
    dp_clip_noise_ref,
    flash_attention_ref,
    mamba2_ssd_ref,
    quantize_decompress_ref,
    rwkv6_scan_ref,
)
from repro_torch.kernels.row_reduce import cluster_shape
from repro_torch.kernels.row_reduce import variant as _row_variant
from repro_torch.kernels.rwkv6_scan import _variant as _rwkv_variant
from repro_torch.kernels.rwkv6_scan import rwkv6_scan

ATOL = 1e-6


def _rows(rows, n, scale, seed):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(rows, n)) * scale).astype(np.float32)
    noise = rng.normal(size=(rows, n)).astype(np.float32)
    sigma = rng.uniform(0.1, 2.0, size=rows).astype(np.float32)
    return g, noise, sigma


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


# rows of different norms: some clipped, some passed through; N not a
# multiple of any block size the Pallas kernel is run with
@pytest.mark.parametrize("rows,n,scale", [(1, 1, 3.0), (3, 37, 1.0),
                                          (5, 1000, 0.05), (4, 5003, 10.0)])
@pytest.mark.parametrize("with_noise", [True, False])
def test_plain_version_matches_pallas_interpret_and_jax_ref(rows, n, scale,
                                                            with_noise):
    g, noise, sigma = _rows(rows, n, scale, seed=rows * 7 + n)
    clip = 1.0
    tg, tn, ts = _torch(g, noise, sigma)
    y, norm = dp_clip_noise(tg, tn if with_noise else None, clip, ts)
    assert y.dtype == torch.float32 and y.shape == (rows, n)
    for r in range(rows):
        nz = jnp.asarray(noise[r]) if with_noise else None
        want_i = jax_dp_clip_noise(jnp.asarray(g[r]), nz, clip,
                                   float(sigma[r]), block=256,
                                   interpret=True)
        want_r = jref.dp_clip_noise_ref(jnp.asarray(g[r]), nz, clip,
                                        float(sigma[r]))
        for wy, wn in (want_i, want_r):
            np.testing.assert_allclose(y[r].numpy(), np.asarray(wy),
                                       rtol=0, atol=ATOL)
            np.testing.assert_allclose(float(norm[r]), float(wn), rtol=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_norm_bound(seed):
    """sigma = 0: every row's output norm is <= min(clip, its norm)."""
    rng = np.random.default_rng(seed)
    rows, n = int(rng.integers(1, 6)), int(rng.integers(1, 5000))
    clip = float(rng.uniform(0.01, 10.0))
    g = torch.as_tensor((rng.normal(size=(rows, n)) * 10).astype(np.float32))
    y, norm = dp_clip_noise(g, torch.zeros_like(g), clip,
                            torch.zeros((rows,)))
    out = torch.linalg.norm(y, dim=1)
    assert torch.all(out <= torch.minimum(torch.tensor(clip), norm)
                     * (1 + 1e-4))


@pytest.mark.parametrize("seed", range(4))
def test_passthrough_below_clip(seed):
    """Rows already inside the clip ball pass through untouched."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(3, int(rng.integers(1, 2000))))
    g = (g / np.linalg.norm(g, axis=1, keepdims=True) * 0.5).astype(np.float32)
    y, norm = dp_clip_noise(torch.as_tensor(g), None, 1.0, None)
    np.testing.assert_allclose(y.numpy(), g, rtol=1e-6, atol=1e-7)
    assert torch.all(norm <= 0.5 * (1 + 1e-5))


def test_per_row_sigma():
    """Each row takes its own sigma: a zero clip-free row with unit noise
    comes out as exactly sigma[r] * noise[r]."""
    g = torch.zeros((3, 11))
    noise = torch.ones((3, 11))
    sigma = torch.tensor([0.0, 0.5, 2.0])
    y, norm = dp_clip_noise(g, noise, 1.0, sigma)
    np.testing.assert_array_equal(y.numpy(), np.repeat(
        sigma.numpy()[:, None], 11, axis=1))
    np.testing.assert_array_equal(norm.numpy(), np.zeros(3, np.float32))


def test_strided_noise_rows():
    """Noise rows may be a strided view (step t of a (C, tau, N) block)."""
    g, _, sigma = _rows(4, 33, 2.0, seed=3)
    block = np.random.default_rng(4).normal(size=(4, 3, 33)).astype(
        np.float32)
    tg, ts = _torch(g, sigma)
    got = dp_clip_noise(tg, torch.as_tensor(block)[:, 1], 1.0, ts)
    want = dp_clip_noise(tg, torch.as_tensor(block[:, 1].copy()), 1.0, ts)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("bad", ["dtype", "rank", "noise_shape", "sigma",
                                 "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    g = torch.ones((2, 5))
    noise, sigma = torch.ones((2, 5)), torch.ones((2,))
    if bad == "dtype":
        g = g.double()
    elif bad == "rank":
        g = g.reshape(10)
    elif bad == "noise_shape":
        noise = torch.ones((2, 4))
    elif bad == "sigma":
        sigma = torch.ones((3,))
    else:
        g, noise, sigma = torch.ones((2, 0)), torch.ones((2, 0)), sigma
    with pytest.raises(ValueError):
        dp_clip_noise(g, noise, 1.0, sigma)


# ------------------------------ tree wrapper --------------------------------

def _jax_noise(key, tree_np):
    """JAX's noise draw of ops.dp_clip_noise_tree (ops.py:44-47): one normal
    per leaf from split keys, in leaf order, laid end to end."""
    leaves = jax.tree.leaves(tree_np)
    keys = jax.random.split(key, len(leaves))
    return np.concatenate([np.asarray(jax.random.normal(
        k, x.shape, jnp.float32)).reshape(-1) for k, x in zip(keys, leaves)])


def test_tree_wrapper_matches_jax_with_injected_noise():
    rng = np.random.default_rng(0)
    rows = 3
    trees = [{"w": (rng.normal(size=(6, 2)) * s).astype(np.float32),
              "b": (rng.normal(size=(2,)) * s).astype(np.float32),
              "z": {"c": (rng.normal(size=(5,)) * s).astype(np.float32)}}
             for s in (0.1, 1.0, 10.0)]
    sigmas = np.asarray([0.3, 0.7, 1.5], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), rows)
    noise = np.stack([_jax_noise(k, t) for k, t in zip(keys, trees)])
    batched = {"w": torch.as_tensor(np.stack([t["w"] for t in trees])),
               "b": torch.as_tensor(np.stack([t["b"] for t in trees])),
               "z": {"c": torch.as_tensor(np.stack([t["z"]["c"]
                                                    for t in trees]))}}
    for backend in ("auto", "ref"):
        got, norm = dp_clip_noise_tree(batched, torch.as_tensor(noise), 1.0,
                                       torch.as_tensor(sigmas),
                                       backend=backend)
        for r in range(rows):
            want, wnorm = jax_dp_clip_noise_tree(
                jax.tree.map(jnp.asarray, trees[r]), keys[r], 1.0,
                float(sigmas[r]), backend="ref")
            for k in ("w", "b"):
                np.testing.assert_allclose(got[k][r].numpy(),
                                           np.asarray(want[k]), atol=ATOL)
            np.testing.assert_allclose(got["z"]["c"][r].numpy(),
                                       np.asarray(want["z"]["c"]), atol=ATOL)
            np.testing.assert_allclose(float(norm[r]), float(wnorm),
                                       rtol=1e-6)


def test_tree_wrapper_clip_only_keeps_dtypes():
    tree = {"w": torch.randn((2, 9, 4), dtype=torch.bfloat16) * 10,
            "b": torch.randn((2, 7))}
    out, norm = dp_clip_noise_tree(tree, None, 1.0, None)
    assert out["w"].dtype == torch.bfloat16 and out["b"].dtype == torch.float32
    assert out["w"].shape == (2, 9, 4) and norm.shape == (2,)


def test_tree_wrapper_rejects_unknown_backend():
    with pytest.raises(ValueError):
        dp_clip_noise_tree({"b": torch.ones((1, 2))}, None, 1.0, None,
                           backend="pallas")


# --------------------------- quantize_decompress -----------------------------

@pytest.mark.parametrize("bad", ["dtype", "rank", "u_shape", "u_dtype",
                                 "u_strided", "empty", "bits0", "bits17",
                                 "bits_float", "bits_bool"])
def test_quantize_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, u, bits = torch.ones((2, 5)), torch.full((2, 5), 0.5), 8
    if bad == "dtype":
        x = x.double()
    elif bad == "rank":
        x, u = x.reshape(10), u.reshape(10)
    elif bad == "u_shape":
        u = torch.full((2, 4), 0.5)
    elif bad == "u_dtype":
        u = u.double()
    elif bad == "u_strided":
        u = torch.full((5, 2), 0.5).t()
    elif bad == "empty":
        x, u = torch.ones((2, 0)), torch.ones((2, 0))
    else:
        bits = {"bits0": 0, "bits17": 17, "bits_float": 8.0,
                "bits_bool": True}[bad]
    with pytest.raises(ValueError):
        quantize_decompress(x, u, bits)


def test_quantize_rows_backends_agree_on_cpu_and_reject_unknown():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(3, 50)).astype(np.float32))
    u = torch.as_tensor(rng.uniform(size=(3, 50)).astype(np.float32))
    got = quantize_decompress_rows(x, u, 6, backend="auto")
    want = quantize_decompress_rows(x, u, 6, backend="ref")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        quantize_decompress_rows(x, u, 6, backend="pallas")


# ---------------- the row-reduce instances of both kernels -------------------

@pytest.mark.parametrize("rows,n,want", [
    (16, 210, "row_cta"), (23, 202, "row_cta"), (1, 1, "row_cta"),
    (100_000, 210, "row_cta"), (3, 4096, "row_cta"), (3, 4097, "row_cluster"),
    (64, 262_144, "row_cluster"), (1, 262_144, "row_cluster"),
    (2, 262_145, "row_stream"), (16, 4_194_304, "row_stream")])
def test_row_variant_picks_by_row_length_at_the_boundaries(rows, n, want):
    assert _row_variant(rows, n) == want


@pytest.mark.parametrize("rows,n", [(0, 5), (5, 0), (2**31, 210),
                                    (2**28, 262_144)])
def test_row_variant_refuses_empty_rows_and_grids_past_one_launch(rows, n):
    with pytest.raises(ValueError):
        _row_variant(rows, n)


@pytest.mark.parametrize("n", [4097, 5000, 8193, 65_536, 100_003, 131_071,
                               262_143, 262_144])
def test_row_cluster_shape_covers_the_row_on_chip(n):
    """2-16 CTAs, each slice a multiple of 4 elements (so it starts at the
    row's 16-byte phase) that fits its 64 KiB, none of them empty."""
    ctas, per = cluster_shape(n)
    assert 2 <= ctas <= 16 and per % 4 == 0 and per <= 16_384
    assert (ctas - 1) * per < n <= ctas * per


def test_row_launch_argument_matches_the_c_struct():
    """The packed argument is rowred::Args: fourteen 8-byte fields, the
    fifth (the clip norm / 1 / levels) a double."""
    from repro_torch.kernels.row_reduce import _ARGS
    assert _ARGS.size == 14 * 8
    fields = _ARGS.unpack(_ARGS.pack(*range(5), 0.25, *range(6, 14)))
    assert fields[5] == 0.25 and fields[:5] == (0, 1, 2, 3, 4)


def _fma32(a, b, c):
    """fmaf on float32 arrays: the exact product (a 48-bit mantissa fits
    f64) plus c, rounded to f64 and then to f32."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _tree32(v):
    """The card's __shfl_down tree over the last axis (32 lanes): lane i
    adds lane i + off for off = 16, 8, 4, 2, 1; lane 0's result."""
    for off in (16, 8, 4, 2, 1):
        v = (v[..., :off] + v[..., off:2 * off]).astype(np.float32)
    return v[..., 0]


def _row_norm_emulation(row, ctas, per, threads=256):
    """The norm of one row as row_cta (ctas 1, per n) and row_cluster take
    it: CTA c holds elements [c per, (c + 1) per); its thread t folds
    elements t, t + 256, ... by fmaf from 0; each warp's shuffle tree; warp
    0's tree over the 8 warp values (the other lanes 0); the CTAs' partials
    added in rank order; sqrt. Elements past the row count as 0, which
    adds nothing."""
    steps = -(-per // threads)
    x = np.zeros((ctas, steps * threads), np.float32)
    flat = np.zeros(ctas * per, np.float32)
    flat[:row.size] = row
    x[:, :per] = flat.reshape(ctas, per)
    x = x.reshape(ctas, steps, threads)
    acc = np.zeros((ctas, threads), np.float32)
    for k in range(steps):
        acc = _fma32(x[:, k], x[:, k], acc)
    warps = _tree32(acc.reshape(ctas, threads // 32, 32))
    part = _tree32(np.pad(warps, ((0, 0), (0, 32 - threads // 32))))
    total = np.float32(0)
    for p in part:
        total = np.float32(total + p)
    return np.sqrt(total)


@pytest.mark.parametrize("n", [210, 4096, 100_003, 262_144])
@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_row_norm_emulation_matches_pallas_interpret(n, scale):
    """The card's reduction order for the norm (row_cta at 210 and 4,096,
    row_cluster at 100,003 and 262,144), emulated in numpy, within rtol
    1e-5 of the Pallas kernel in interpret mode on the same input."""
    g = (np.random.default_rng(n).normal(size=n) * scale).astype(np.float32)
    shape = cluster_shape(n) if _row_variant(1, n) == "row_cluster" else (
        1, n)
    got = _row_norm_emulation(g, *shape)
    _, want = jax_dp_clip_noise(jnp.asarray(g), None, 1.0, 0.0,
                                interpret=True)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    np.testing.assert_allclose(got, np.linalg.norm(g.astype(np.float64)),
                               rtol=1e-6)


# -------------------------- cohort_gather_scatter ----------------------------

def _cohort_arrays(s, k, d, dtype, seed):
    """A numpy (S, D) cache, K unique slots and (K, D) rows; ``dtype`` is a
    numpy dtype name or "bfloat16" (made as f32 values bf16 holds)."""
    rng = np.random.default_rng(seed)
    slots = rng.permutation(s)[:k].astype(np.int32)
    if dtype == "int32":
        return (rng.integers(-2**31, 2**31 - 1, size=(s, d), dtype=np.int32),
                slots,
                rng.integers(-2**31, 2**31 - 1, size=(k, d), dtype=np.int32))
    cache = rng.normal(size=(s, d)).astype(np.float32)
    rows = rng.normal(size=(k, d)).astype(np.float32)
    if dtype == "bfloat16":       # values bf16 holds exactly
        cache = (cache.view(np.uint32) & 0xFFFF0000).view(np.float32)
        rows = (rows.view(np.uint32) & 0xFFFF0000).view(np.float32)
    return cache, slots, rows


def _to_torch(a, dtype):
    t = torch.as_tensor(a)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _to_jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else None)


def _bits(x) -> np.ndarray:
    """The raw bits of a torch or JAX array, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.uint8)
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x.view(np.uint8)


# the shapes of tests/test_kernels.py's cohort_gather_scatter cases, plus
# int32 rows (the data leaves' labels) and the resident driver's residual
COHORT_CASES = [(9, 3, 5, "float32"), (64, 8, 130, "float32"),
                (16, 4, 33, "bfloat16"), (9, 3, 5, "int32"),
                (256, 16, 40, "int32"), (256, 16, 42, "float32")]


@pytest.mark.parametrize("s,k,d,dtype", COHORT_CASES,
                         ids=[f"s{s}-k{k}-d{d}-{t}"
                              for s, k, d, t in COHORT_CASES])
@pytest.mark.parametrize("scatter", [False, True], ids=["gather", "scatter"])
def test_cohort_plain_version_matches_jax_ref_and_pallas_bitwise(s, k, d,
                                                                 dtype,
                                                                 scatter):
    cache, slots, rows = _cohort_arrays(s, k, d, dtype, seed=s + k + d)
    tc, ts, tr = _to_torch(cache, dtype), torch.as_tensor(slots), \
        _to_torch(rows, dtype)
    jargs = (_to_jax(cache, dtype), jnp.asarray(slots)) + (
        (_to_jax(rows, dtype),) if scatter else ())
    got = cohort_gather_scatter(tc, ts, tr if scatter else None)
    want_ref = jref.cohort_gather_scatter_ref(*jargs)
    want_pallas = jax_cohort_gather_scatter(*jargs, interpret=True)
    assert got.shape == want_ref.shape
    np.testing.assert_array_equal(_bits(got), _bits(want_ref))
    np.testing.assert_array_equal(_bits(got), _bits(want_pallas))
    if scatter:                     # in place: the cache itself came back
        assert got is tc


def test_cohort_gather_is_a_copy_and_scatter_keeps_other_rows():
    """The gathered rows do not alias the cache (a later scatter leaves them
    alone), and a scatter changes exactly the slot rows."""
    cache, slots, rows = _cohort_arrays(12, 4, 7, "float32", seed=0)
    tc = torch.as_tensor(cache.copy())
    ts = torch.as_tensor(slots).to(torch.int64)
    before = cohort_gather(tc, ts)
    ptr = tc.data_ptr()
    out = cohort_scatter(tc, ts, torch.as_tensor(rows))
    assert out.data_ptr() == ptr
    np.testing.assert_array_equal(before.numpy(), cache[slots])
    want = cache.copy()
    want[slots] = rows
    np.testing.assert_array_equal(tc.numpy(), want)
    for backend in ("auto", "ref"):
        np.testing.assert_array_equal(
            cohort_gather(tc, ts, backend=backend).numpy(), rows)


@pytest.mark.parametrize("bad", ["rank", "empty_cache", "slots_float",
                                 "slots_rank", "slots_empty", "rows_dtype",
                                 "rows_shape", "rows_strided", "backend"])
def test_cohort_wrapper_rejects_what_the_kernel_does_not_take(bad):
    cache = torch.zeros((6, 4))
    slots = torch.tensor([0, 3], dtype=torch.int64)
    rows = torch.ones((2, 4))
    if bad == "rank":
        cache = cache.reshape(24)
    elif bad == "empty_cache":
        cache = torch.zeros((6, 0))
        rows = torch.zeros((2, 0))
    elif bad == "slots_float":
        slots = slots.float()
    elif bad == "slots_rank":
        slots = slots.reshape(1, 2)
    elif bad == "slots_empty":
        slots = slots[:0]
    elif bad == "rows_dtype":
        rows = rows.double()
    elif bad == "rows_shape":
        rows = torch.ones((3, 4))
    elif bad == "rows_strided":
        rows = torch.ones((4, 2)).t()
    with pytest.raises(ValueError):
        if bad == "backend":
            cohort_scatter(cache, slots, rows, backend="pallas")
        else:
            cohort_gather_scatter(cache, slots, rows)


@pytest.mark.parametrize("bad,scatter", [
    (bad, scatter) for bad in ("cache_strided", "slots_int16", "slots_device")
    for scatter in (False, True)] + [("rows_device", True)])
def test_cohort_wrapper_refusals_beyond_shape_and_dtype(bad, scatter):
    """The other refusals of the wrapper's check: a strided cache, slots of
    another integer type, and slots or rows on another device than the
    cache (the meta device stands in for a second device here)."""
    cache = torch.zeros((6, 4))
    slots = torch.tensor([0, 3], dtype=torch.int32)
    rows = torch.ones((2, 4))
    if bad == "cache_strided":
        cache = torch.zeros((4, 6)).t()
    elif bad == "slots_int16":
        slots = slots.to(torch.int16)
    elif bad == "slots_device":
        slots = slots.to("meta")
    elif bad == "rows_device":
        rows = rows.to("meta")
    with pytest.raises(ValueError):
        cohort_gather_scatter(cache, slots, rows if scatter else None)


@pytest.mark.parametrize("s,k,d,dtype", COHORT_CASES,
                         ids=[f"s{s}-k{k}-d{d}-{t}"
                              for s, k, d, t in COHORT_CASES])
def test_cohort_int32_and_int64_slots_give_the_same_rows(s, k, d, dtype):
    """The wrapper takes the cohort's int32 slots as they are: gather and
    scatter give the same bits as with the same slots in int64, and a
    strided slot view the same as its contiguous copy."""
    cache, slots, rows = _cohort_arrays(s, k, d, dtype, seed=s * k + d)
    tc, tr = _to_torch(cache, dtype), _to_torch(rows, dtype)
    s32 = torch.as_tensor(slots)
    assert s32.dtype == torch.int32
    s64 = s32.to(torch.int64)
    strided = torch.stack([s32, s32], dim=1)[:, 0]
    assert not strided.is_contiguous()
    got = [cohort_gather_scatter(tc, sl) for sl in (s32, s64, strided)]
    for g in got[1:]:
        np.testing.assert_array_equal(_bits(g), _bits(got[0]))
    caches = [tc.clone() for _ in range(3)]
    for c, sl in zip(caches, (s32, s64, strided)):
        cohort_gather_scatter(c, sl, tr)
    for c in caches[1:]:
        np.testing.assert_array_equal(_bits(c), _bits(caches[0]))


def test_cohort_plain_version_refuses_out_of_range_slots():
    with pytest.raises(IndexError):
        cohort_gather(torch.zeros((4, 3)), torch.tensor([1, 4]))


# ---------------- flash_attention, rwkv6_scan, mamba2_ssd -------------------
# Inputs are made with numpy from a seed and fed to both packages; bf16 cases
# round the same numpy values into each package's bf16.

def _np_rng(*key):
    """A numpy generator seeded from ``key`` (stable across processes)."""
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _in(a, dtype):
    """numpy f32 -> (torch tensor, jax array) in ``dtype``."""
    if dtype == "bfloat16":
        return (torch.as_tensor(a).to(torch.bfloat16),
                jnp.asarray(a, jnp.bfloat16))
    return torch.as_tensor(a), jnp.asarray(a)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# (B, H, S, hd, window, Pallas block): tests/test_kernels.py's shape, S not a
# multiple of the CUDA kernels' 32- and 64-row tiles, hd 32 / 64 / 112,
# windows that bite and that do not (W >= S), and S = 1
FLASH_CASES = [(1, 4, 128, 32, 0, 32), (1, 4, 128, 32, 24, 32),
               (2, 2, 40, 32, 0, 8), (1, 2, 37, 112, 0, 37),
               (1, 2, 37, 112, 16, 37), (2, 3, 70, 64, 100, 10),
               (1, 1, 1, 32, 0, 1)]
# f32: the online softmax of the Pallas kernel and the one-pass softmax of
# the plain version sum in another order (gaps ~6e-7). bf16: the plain
# version, like JAX's reference, rounds scores and probabilities to bf16
# (gaps to JAX's reference: the two frameworks' bf16 products, ~1 bf16 ulp
# of the output, 2^-8 relative); against the Pallas kernel, which keeps them
# in f32, the scores' rounding adds a few ulps more.
FLASH_TOL = {"float32": dict(atol=2e-6, rtol=2e-5),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}


@pytest.mark.parametrize("b,h,s,hd,window,block", FLASH_CASES,
                         ids=[f"b{c[0]}h{c[1]}s{c[2]}d{c[3]}w{c[4]}"
                              for c in FLASH_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_version_matches_pallas_interpret_and_jax_ref(
        b, h, s, hd, window, block, dtype):
    rng = _np_rng("flash", b, h, s, hd)
    q, k, v = (rng.normal(size=(b, h, s, hd)).astype(np.float32)
               for _ in range(3))
    (tq, jq), (tk, jk), (tv, jv) = (_in(a, dtype) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, window=window)
    assert got.dtype == tq.dtype and got.shape == (b, h, s, hd)
    want_pallas = jax_flash_attention(jq, jk, jv, window=window,
                                      block_q=block, block_k=block,
                                      interpret=True)
    want_ref = jref.flash_attention_ref(jq, jk, jv, window=window)
    for want in (want_pallas, want_ref):
        np.testing.assert_allclose(_f32(got), _f32(want), **FLASH_TOL[dtype])


def test_flash_window_at_least_s_is_full_causal():
    rng = _np_rng("flash-window")
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 2, 19, 16))
                               .astype(np.float32)) for _ in range(3))
    assert torch.equal(flash_attention(q, k, v, window=19),
                       flash_attention(q, k, v))
    assert not torch.equal(flash_attention(q, k, v, window=18),
                           flash_attention(q, k, v))


def test_flash_plain_version_matches_model_blocked_attention():
    """The plain version == the JAX model's jnp baseline (GQA expanded),
    at tests/test_kernels.py's tolerance."""
    rng = _np_rng("flash-model")
    b, s, h, hd = 1, 128, 4, 32
    q, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    for window in (0, 24):
        want = blocked_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), window=window,
                                        block_q=32)
        got = ops.flash_attention(
            *(torch.as_tensor(a).transpose(1, 2).contiguous()
              for a in (q, k, v)), window=window).transpose(1, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("hd", range(16, 257, 16))
def test_flash_variant_is_tc_for_bf16_at_multiples_of_16(hd):
    assert _variant(hd, torch.bfloat16) == "tc"
    assert _variant(hd, torch.float32) == "simt"


@pytest.mark.parametrize("hd", [1, 20, 40, 100, 255])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_variant_is_simt_for_f32_and_other_head_dims(hd, dtype):
    assert _variant(hd, dtype) == "simt"


@pytest.mark.parametrize("hd,dtype", [(257, torch.bfloat16),
                                      (512, torch.float32),
                                      (0, torch.bfloat16),
                                      (64, torch.float16)])
def test_flash_variant_refuses_what_no_instance_takes(hd, dtype):
    with pytest.raises(ValueError):
        _variant(hd, dtype)


def _rwkv_inputs(b, h, s, hd, with_s0, seed_key, decay="sigmoid"):
    """r, k, v, w, u, s0 from a seed. ``decay`` draws w: "sigmoid" (the
    tests' sigmoid(randn)), "model" (the model's init, exp(-exp(-6 + 0.5
    randn)), w ~ 0.9975), "strong" (-ln w ~ e^1.5 ~ 4.5) or "edges"
    (sigmoid with ~5% of w exactly 0 and ~5% exactly 1)."""
    rng = _np_rng("rwkv", *seed_key)
    r, k, v = (rng.normal(size=(b, h, s, hd)).astype(np.float32)
               for _ in range(3))
    z = rng.normal(size=(b, h, s, hd))
    if decay == "model":
        w = np.exp(-np.exp(-6 + 0.5 * z))
    elif decay == "strong":
        w = np.exp(-np.exp(1.5 + 0.5 * z))
    else:
        w = 1 / (1 + np.exp(-z))
    w = w.astype(np.float32)
    if decay == "edges":
        pick = rng.random(size=w.shape)
        w[pick < 0.05] = 0.0
        w[pick > 0.95] = 1.0
    u = rng.normal(size=(h, hd)).astype(np.float32)
    s0 = (rng.normal(size=(b, h, hd, hd)).astype(np.float32)
          if with_s0 else None)
    return r, k, v, w, u, s0


# (B, H, S, hd): tests/test_kernels.py's shape, S = 1 (a decode step), S not
# a multiple of the CUDA kernel's 32-token staging, hd 32 and 64
RWKV_CASES = [(2, 3, 12, 8), (2, 3, 1, 8), (1, 2, 45, 32), (2, 2, 33, 64)]


@pytest.mark.parametrize("b,h,s,hd", RWKV_CASES,
                         ids=[f"b{c[0]}h{c[1]}s{c[2]}d{c[3]}"
                              for c in RWKV_CASES])
@pytest.mark.parametrize("with_s0", [False, True], ids=["zero", "s0"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_plain_version_matches_pallas_interpret_and_jax_ref(
        b, h, s, hd, with_s0, dtype):
    """r / k / v in ``dtype``, w / u / s0 f32, as the model passes them.
    The plain version equals the Pallas kernel (the same sequential f32
    recurrence) within 1e-5 and JAX's reference within 1e-5 (after the
    reference's f32 y is rounded to r's dtype, as the kernels round it);
    the final state within 1e-5 of both."""
    r, k, v, w, u, s0 = _rwkv_inputs(b, h, s, hd, with_s0, (b, h, s, hd))
    (tr, jr), (tk, jk), (tv, jv) = (_in(a, dtype) for a in (r, k, v))
    tw, tu = torch.as_tensor(w), torch.as_tensor(u)
    ts0 = None if s0 is None else torch.as_tensor(s0)
    js0 = None if s0 is None else jnp.asarray(s0)
    y, st = ops.rwkv6_scan(tr, tk, tv, tw, tu, ts0)
    assert y.dtype == tr.dtype and st.dtype == torch.float32
    wy_p, ws_p = jax_rwkv6_scan(jr, jk, jv, jnp.asarray(w), jnp.asarray(u),
                                js0, interpret=True)
    wy_r, ws_r = jref.rwkv6_scan_ref(jr, jk, jv, jnp.asarray(w),
                                     jnp.asarray(u), js0)
    wy_r = wy_r.astype(jr.dtype)
    ytol = (dict(atol=1e-5, rtol=1e-5) if dtype == "float32"
            # one bf16 rounding of y on both sides; f32 sums in another
            # order can move it across a rounding boundary: 1 ulp
            else dict(atol=1e-2, rtol=8e-3))
    for wy, ws in ((wy_p, ws_p), (wy_r, ws_r)):
        np.testing.assert_allclose(_f32(y), _f32(wy), **ytol)
        np.testing.assert_allclose(st.numpy(), np.asarray(ws), atol=1e-5,
                                   rtol=1e-5)


def test_rwkv_plain_version_matches_model_scan():
    """The plain version == the JAX model's wkv6_scan (its lax.scan
    baseline) at tests/test_kernels.py's tolerance, with and without s0."""
    b, h, s, hd = 2, 3, 12, 8
    for with_s0 in (False, True):
        r, k, v, w, u, s0 = _rwkv_inputs(b, h, s, hd, with_s0, ("model",))
        perm = lambda a: np.ascontiguousarray(np.moveaxis(a, 1, 2))  # noqa
        want_y, want_s = jax_wkv6_scan(
            *(jnp.asarray(perm(a)) for a in (r, k, v, w)), jnp.asarray(u),
            None if s0 is None else jnp.asarray(s0))
        y, st = ops.rwkv6_scan(*(torch.as_tensor(a) for a in (r, k, v, w, u)),
                               None if s0 is None else torch.as_tensor(s0))
        np.testing.assert_allclose(y.transpose(1, 2).numpy(),
                                   np.asarray(want_y), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_s), rtol=1e-4,
                                   atol=1e-5)


def _ssd_inputs(b, s, h, p, n, seed_key):
    rng = _np_rng("ssd", *seed_key)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a = (-np.exp(rng.normal(size=(h,)) * 0.3)).astype(np.float32)
    b_in = rng.normal(size=(b, s, n)).astype(np.float32)
    c_in = rng.normal(size=(b, s, n)).astype(np.float32)
    return x, dt, a, b_in, c_in


# (B, S, H, P, N, chunk): tests/test_kernels.py's shape (4 chunks), several
# chunks at other widths, one chunk, and chunk > S (clamped to S)
SSD_CASES = [(2, 32, 2, 8, 4, 8), (1, 64, 3, 16, 8, 16),
             (2, 24, 2, 8, 4, 24), (1, 12, 2, 32, 16, 128)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES,
                         ids=[f"b{c[0]}s{c[1]}h{c[2]}p{c[3]}n{c[4]}q{c[5]}"
                              for c in SSD_CASES])
def test_ssd_plain_version_matches_pallas_interpret_and_jax_refs(
        b, s, h, p, n, chunk):
    """f32: the plain version computes the Pallas kernel's per-chunk math
    (gaps ~2e-6); JAX's sequential reference and the model's ssd_chunked
    sum in another order (tests/test_kernels.py's 1e-3 / 1e-4)."""
    x, dt, a, b_in, c_in = _ssd_inputs(b, s, h, p, n, (b, s, h, p, n))
    jin = [jnp.asarray(t) for t in (x, dt, a, b_in, c_in)]
    y, st = ops.mamba2_ssd(*(torch.as_tensor(t)
                             for t in (x, dt, a, b_in, c_in)), chunk=chunk)
    assert y.shape == x.shape and st.shape == (b, h, p, n)
    wy, ws = jax_mamba2_ssd(*jin, chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(ws), atol=1e-5,
                               rtol=1e-5)
    for wy, ws in (jref.mamba2_ssd_ref(*jin),
                   jax_ssd_chunked(*jin, chunk=min(chunk, s))):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(ws), rtol=1e-3,
                                   atol=1e-4)


def test_ssd_plain_version_bf16_inputs():
    """bf16 x / b / c (dt, a f32): y comes back in bf16, within 1 bf16 ulp
    of the same computation on the f32 upcast of those inputs (the only
    rounding is y's), and the f32 state matches it within 1e-5."""
    x, dt, a, b_in, c_in = _ssd_inputs(2, 32, 2, 8, 4, ("bf16",))
    tx, tb, tc = (torch.as_tensor(t).to(torch.bfloat16)
                  for t in (x, b_in, c_in))
    td, ta = torch.as_tensor(dt), torch.as_tensor(a)
    y, st = mamba2_ssd(tx, td, ta, tb, tc, chunk=8)
    wy, ws = mamba2_ssd_ref(tx.float(), td, ta, tb.float(), tc.float(), 8)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), wy.numpy(), atol=1e-2,
                               rtol=8e-3)
    np.testing.assert_allclose(st.numpy(), ws.numpy(), atol=1e-5, rtol=1e-5)


def test_ssd_refuses_a_sequence_the_chunk_does_not_divide():
    x, dt, a, b_in, c_in = _ssd_inputs(1, 20, 2, 8, 4, ("ragged",))
    with pytest.raises(ValueError):
        mamba2_ssd(*(torch.as_tensor(t) for t in (x, dt, a, b_in, c_in)),
                   chunk=8)


@pytest.mark.parametrize("q", [64, 128])
@pytest.mark.parametrize("p", [16, 32, 64, 128])
@pytest.mark.parametrize("n", [16, 32, 64, 128])
def test_ssd_variant_is_tc_for_bf16_at_64_row_chunks_and_k16_widths(q, p, n):
    assert _ssd_variant(q, p, n, torch.bfloat16) == "tc"


@pytest.mark.parametrize("q", [64, 128])
@pytest.mark.parametrize("p", [16, 32, 64])
@pytest.mark.parametrize("n", [16, 32, 64])
def test_ssd_variant_is_simt_for_f32(q, p, n):
    assert _ssd_variant(q, p, n, torch.float32) == "simt"


@pytest.mark.parametrize("q", [8, 16, 24])
@pytest.mark.parametrize("p,n", [(8, 4), (16, 8), (8, 8), (16, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_variant_is_simt_where_the_tiles_do_not_fit(q, p, n, dtype):
    assert _ssd_variant(q, p, n, dtype) == "simt"


@pytest.mark.parametrize("q,p,n,dtype", [
    (256, 128, 128, torch.float32), (128, 128, 128, torch.float32),
    (128, 512, 64, torch.bfloat16),
    (64, 64, 64, torch.float16), (0, 64, 64, torch.bfloat16),
    (128, 64, 0, torch.float32)])
def test_ssd_variant_refuses_what_no_instance_takes(q, p, n, dtype):
    with pytest.raises(ValueError):
        _ssd_variant(q, p, n, dtype)


def _bf16_terms(v, terms):
    """v (f32) as ``terms`` bf16 values (as f32) whose sum approximates v:
    hi = bf16(v), lo = bf16(v - hi), ..., the kernel's operand split."""
    out = []
    for _ in range(terms):
        t = v.to(torch.bfloat16).to(torch.float32)
        out.append(t)
        v = v - t
    return out


def _ssd_tc_emulation(x, dt, a, b_in, c_in, chunk):
    """The tensor-core SSD instance's arithmetic in plain PyTorch, on bf16
    x, b, c: per chunk M = G 2^(L_t log2(e) - q_s) with q_s = L_s log2(e)
    - log2(dt_s), M and the state entering the products as bf16 hi + lo,
    w x as three bf16 terms, every product of bf16 values accumulated in
    f32 (exact products), the state kept in f32. Returns (y in bf16, final
    state f32)."""
    f32 = torch.float32
    bsz, s, h, p = x.shape
    xs = x.to(f32).permute(0, 2, 1, 3)                      # (B, H, S, P)
    dts = dt.permute(0, 2, 1)
    bs, cs = b_in.to(f32)[:, None], c_in.to(f32)[:, None]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    state = torch.zeros((bsz, h, p, b_in.shape[-1]), dtype=f32)
    ys = []
    for c0 in range(0, s, chunk):
        xc, dtc = xs[:, :, c0:c0 + chunk], dts[:, :, c0:c0 + chunk]
        bc, cc = bs[:, :, c0:c0 + chunk], cs[:, :, c0:c0 + chunk]
        l = torch.cumsum(dtc * a[None, :, None], dim=-1)
        l2 = l * np.float32(1.4426950408889634)
        q = l2 - torch.log2(dtc)
        m = torch.where(tri, (cc @ bc.transpose(-1, -2))
                        * torch.exp2(l2[..., :, None] - q[..., None, :]),
                        torch.zeros(()))
        y = sum(cc @ t.transpose(-1, -2) for t in _bf16_terms(state, 2))
        y = y * torch.exp(l)[..., None]
        for t in _bf16_terms(m, 2):
            y = y + t @ xc
        w = torch.exp(l[..., -1:] - l) * dtc
        wx = (w[..., None] * xc).transpose(-1, -2)           # (B, H, P, Q)
        state = torch.exp(l[..., -1])[..., None, None] * state + sum(
            t @ bc for t in _bf16_terms(wx, 3))
        ys.append(y)
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3).to(x.dtype), state


def _kernel_tol_use(got, want, rtol):
    """max |got - want| / (1e-5 * max(1, max|want|) + rtol |want|): the
    share of chip_smoke.py's ``_kernel_err`` tolerance used (<= 1 passes)."""
    want = torch.as_tensor(np.array(want, np.float32))
    err = (got.float() - want).abs()
    scale = max(1.0, float(want.abs().max()))
    return float((err / (1e-5 * scale + rtol * want.abs())).max())


def _within_kernel_tol(got, want, rtol):
    """chip_smoke.py's ``_kernel_err`` check: |got - want| <= 1e-5 *
    max(1, max|want|) + rtol |want|."""
    return _kernel_tol_use(got, want, rtol) <= 1.0


# SSD_CASES and a multi-chunk case at zamba2's widths (P = N = 64, Q 128)
SSD_EMULATION_CASES = SSD_CASES + [(1, 512, 3, 64, 64, 128)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_EMULATION_CASES,
                         ids=[f"b{c[0]}s{c[1]}h{c[2]}p{c[3]}n{c[4]}q{c[5]}"
                              for c in SSD_EMULATION_CASES])
def test_ssd_tc_emulation_within_the_cards_tolerance(b, s, h, p, n, chunk):
    """The tensor-core instance's arithmetic (bf16 splits, exp2 decay, f32
    accumulation) agrees with the plain version and the Pallas kernel
    (interpret mode), both run in f32 on the same bf16 values, within the
    card's tolerances: y at bf16's (8e-3), the final state at f32's
    (1e-4), each plus 1e-5 of the output's largest magnitude."""
    x, dt, a, b_in, c_in = _ssd_inputs(b, s, h, p, n, ("emu", b, s, h, p))
    x, b_in, c_in = (torch.as_tensor(t).to(torch.bfloat16)
                     for t in (x, b_in, c_in))
    dt, a = torch.as_tensor(dt), torch.as_tensor(a)
    q = min(chunk, s)
    y, st = _ssd_tc_emulation(x, dt, a, b_in, c_in, q)
    assert y.dtype == torch.bfloat16 and st.shape == (b, h, p, n)
    f32_in = [t.float() for t in (x, dt, a, b_in, c_in)]
    wy, ws = mamba2_ssd_ref(*f32_in, q)
    py, ps = jax_mamba2_ssd(*(jnp.asarray(t.numpy()) for t in f32_in),
                            chunk=chunk, interpret=True)
    for want_y, want_s in ((wy, ws), (py, ps)):
        assert _within_kernel_tol(y, want_y, 8e-3)
        assert _within_kernel_tol(st, want_s, 1e-4)


def _split_product(a, b):
    """a @ b with both f32 operands entered as bf16 hi + lo and lo @ lo
    dropped, products of bf16 values summed in f32: the tensor-core
    instance's split products."""
    a_hi, a_lo = _bf16_terms(a, 2)
    b_hi, b_lo = _bf16_terms(b, 2)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


WKV_Q, WKV_SUB = 64, 16              # the tc instance's chunk and sub-chunk
WKV_LOG2_FLOOR = -64.0               # its clamp of log2 w (w = 0)


def _wkv_tc_emulation(r, k, v, w, u, s0=None):
    """The tensor-core WKV instance's arithmetic in plain PyTorch, on bf16
    r, k, v: S padded to chunks of 64 (k = v = r = 0, log2 w = 0), l =
    log2 w clamped at -64, L its cumsum over a chunk in f32; per chunk the
    state's part dS = (k 2^(L_Q - L))^T V, the state passing S <- 2^(L_Q) S
    + dS in f32, and y = A V + (r 2^(L_{t-1})) S_prev with A's off-diagonal
    16-token blocks from the folded factors r 2^(L_{t-1} - L_e) and k
    2^(L_e - L_s) (both <= 1), its diagonal blocks per element in f32
    (with the bonus u on the diagonal). Every f32 operand of a product
    enters as bf16 hi + lo, lo lo dropped (V is bf16, one term). Returns
    (y in r's dtype, final state f32)."""
    f32 = torch.float32
    b, h, s, hd = r.shape
    nc = -(-s // WKV_Q)
    pad = nc * WKV_Q - s
    shape = (b, h, nc, WKV_Q, hd)

    def chunks(t):
        return torch.nn.functional.pad(t.to(f32), (0, 0, 0, pad)).reshape(
            shape)

    rc, kc, vc = chunks(r), chunks(k), chunks(v)
    lc = chunks(torch.clamp(torch.log2(w.to(f32)), min=WKV_LOG2_FLOOR))
    lin = torch.cumsum(lc, dim=3)                        # L_t
    lex = lin - lc                                       # L_{t-1}
    lq = lin[:, :, :, -1]                                # L_Q
    d_state = _split_product(
        (kc * torch.exp2(lq[:, :, :, None] - lin)).transpose(-1, -2), vc)
    state = (torch.zeros((b, h, hd, hd), dtype=f32) if s0 is None
             else s0.to(f32))
    s_prev = []
    for c in range(nc):
        s_prev.append(state)
        state = state * torch.exp2(lq[:, :, c])[..., None] + d_state[:, :, c]
    a = torch.zeros((b, h, nc, WKV_Q, WKV_Q), dtype=f32)
    for blk in range(WKV_Q // WKV_SUB - 1):
        e = WKV_SUB * blk + WKV_SUB - 1
        rows = slice(e + 1, WKV_Q)
        cols = slice(e + 1 - WKV_SUB, e + 1)
        l_e = lin[:, :, :, e:e + 1]
        r_f = rc[:, :, :, rows] * torch.exp2(lex[:, :, :, rows] - l_e)
        k_f = kc[:, :, :, cols] * torch.exp2(l_e - lin[:, :, :, cols])
        a[:, :, :, rows, cols] = _split_product(r_f, k_f.transpose(-1, -2))
    lower = torch.tril(torch.ones((WKV_SUB, WKV_SUB), dtype=torch.bool), -1)
    for blk in range(WKV_Q // WKV_SUB):
        sl = slice(WKV_SUB * blk, WKV_SUB * (blk + 1))
        rb, kb = rc[:, :, :, sl], kc[:, :, :, sl]
        expo = lex[:, :, :, sl, None, :] - lin[:, :, :, None, sl, :]
        decay = torch.exp2(torch.where(lower[..., None], expo,
                                       torch.tensor(-float("inf"))))
        diag = (rb[..., :, None, :] * kb[..., None, :, :] * decay).sum(-1)
        bonus = (rb * u.to(f32)[None, :, None, None, :] * kb).sum(-1)
        a[:, :, :, sl, sl] = diag + torch.diag_embed(bonus)
    a_hi, a_lo = _bf16_terms(a, 2)
    y = a_hi @ vc + a_lo @ vc + _split_product(rc * torch.exp2(lex),
                                               torch.stack(s_prev, 2))
    y = y.reshape(b, h, nc * WKV_Q, hd)[:, :, :s]
    return y.to(r.dtype), state


# RWKV_CASES and rwkv6-1.6b's head width over 8 chunks
WKV_EMULATION_CASES = RWKV_CASES + [(1, 4, 512, 64)]


@pytest.mark.parametrize("b,h,s,hd", WKV_EMULATION_CASES,
                         ids=[f"b{c[0]}h{c[1]}s{c[2]}d{c[3]}"
                              for c in WKV_EMULATION_CASES])
@pytest.mark.parametrize("with_s0", [False, True], ids=["zero", "s0"])
@pytest.mark.parametrize("decay", ["sigmoid", "model", "strong", "edges"])
def test_wkv_tc_emulation_within_the_cards_tolerance(b, h, s, hd, with_s0,
                                                     decay):
    """The tensor-core WKV instance's arithmetic (sub-chunk folded decay,
    bf16 hi + lo operands, f32 accumulation and state, the padded ragged
    chunk) agrees with the plain version, the Pallas kernel (interpret
    mode) and the JAX model's chunk-parallel ``wkv6_chunked`` (fed ln w,
    clamped at the instance's floor where w = 0), all run in f32 on the
    same bf16 values, within the card's tolerances: y at bf16's (8e-3),
    the final state at f32's (1e-4), each plus 1e-5 of the output's largest
    magnitude; in the tests' decay, the model's, a strong one, and with w
    exactly 0 and 1 mixed in."""
    r, k, v, w, u, s0 = _rwkv_inputs(b, h, s, hd, with_s0,
                                     ("emu", b, h, s, hd), decay)
    r, k, v = (torch.as_tensor(t).to(torch.bfloat16) for t in (r, k, v))
    w, u = torch.as_tensor(w), torch.as_tensor(u)
    s0 = None if s0 is None else torch.as_tensor(s0)
    y, st = _wkv_tc_emulation(r, k, v, w, u, s0)
    assert y.dtype == torch.bfloat16 and st.shape == (b, h, hd, hd)
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(st).all())
    r32, k32, v32 = (t.float() for t in (r, k, v))
    js0 = None if s0 is None else jnp.asarray(s0.numpy())
    jin = [jnp.asarray(t.numpy()) for t in (r32, k32, v32, w, u)]
    ln_w = torch.clamp(torch.log(w), min=WKV_LOG2_FLOOR * float(np.log(2)))

    def model_layout(t):                 # (B, H, S, hd) -> (B, S, H, hd)
        return jnp.asarray(np.ascontiguousarray(np.moveaxis(t.numpy(), 1, 2)))

    cy, cs = jax_wkv6_chunked(*(model_layout(t) for t in (r32, k32, v32,
                                                            ln_w)),
                              jnp.asarray(u.numpy()), js0, chunk=64)
    for want_y, want_s in (rwkv6_scan_ref(r32, k32, v32, w, u, s0),
                           jax_rwkv6_scan(*jin, js0, interpret=True),
                           (np.moveaxis(np.asarray(cy), 2, 1), cs)):
        assert _within_kernel_tol(y, want_y, 8e-3)
        assert _within_kernel_tol(st, want_s, 1e-4)


@pytest.mark.parametrize("hd", [16, 32, 48, 64])
@pytest.mark.parametrize("s", [16, 45, 512, 2048])
def test_rwkv_variant_is_tc_for_bf16_at_k16_widths_above_the_threshold(s,
                                                                      hd):
    assert _rwkv_variant(s, hd, torch.bfloat16) == "tc"


@pytest.mark.parametrize("s,hd,dtype", [
    (512, 64, torch.float32), (16, 16, torch.float32),
    (1, 64, torch.bfloat16), (15, 64, torch.bfloat16),
    (1, 64, torch.float32), (512, 8, torch.bfloat16),
    (512, 40, torch.bfloat16), (33, 63, torch.bfloat16)])
def test_rwkv_variant_is_simt_for_f32_short_s_and_other_widths(s, hd, dtype):
    assert _rwkv_variant(s, hd, dtype) == "simt"


@pytest.mark.parametrize("s,hd,dtype", [
    (512, 65, torch.bfloat16), (512, 128, torch.float32),
    (512, 64, torch.float16), (0, 64, torch.bfloat16),
    (512, 0, torch.float32)])
def test_rwkv_variant_refuses_what_no_instance_takes(s, hd, dtype):
    with pytest.raises(ValueError):
        _rwkv_variant(s, hd, dtype)


def _kernel_call(kernel, bad):
    """One call of ``kernel`` with valid small CPU inputs but for ``bad``:
    an input that requires grad, a wrong dtype or a wrong shape."""
    if kernel == "flash":
        args = [torch.ones((1, 2, 5, 8)) for _ in range(3)]
        fn = lambda *a: flash_attention(*a)  # noqa: E731
        slot = 1
    elif kernel == "rwkv":
        args = [torch.ones((1, 2, 5, 8)) for _ in range(4)] + [
            torch.ones((2, 8)), torch.zeros((1, 2, 8, 8))]
        fn = rwkv6_scan
        slot = 3                                   # w
    else:
        args = [torch.ones((1, 8, 2, 4)), torch.ones((1, 8, 2)),
                -torch.ones((2,)), torch.ones((1, 8, 3)),
                torch.ones((1, 8, 3))]
        fn = lambda *a: mamba2_ssd(*a, chunk=4)  # noqa: E731
        slot = 3                                   # b
    if bad == "grad":
        args[slot] = args[slot].clone().requires_grad_(True)
    elif bad == "dtype":
        args[slot] = args[slot].double()
    else:
        args[slot] = args[slot][..., :-1].contiguous()
    return fn, args


@pytest.mark.parametrize("kernel", ["flash", "rwkv", "ssd"])
@pytest.mark.parametrize("bad", ["grad", "dtype", "shape"])
def test_model_kernel_wrappers_refuse_what_the_kernel_does_not_take(kernel,
                                                                    bad):
    fn, args = _kernel_call(kernel, bad)
    with pytest.raises(ValueError):
        fn(*args)


def test_model_kernel_ops_take_ref_and_refuse_unknown_backends():
    rng = _np_rng("ops-backends")
    q = torch.as_tensor(rng.normal(size=(1, 2, 9, 8)).astype(np.float32))
    assert torch.equal(ops.flash_attention(q, q, q, backend="ref"),
                       flash_attention_ref(q, q, q))
    r, k, v, w, u, s0 = (torch.as_tensor(a) for a in
                         _rwkv_inputs(1, 2, 3, 8, True, ("ops",)))
    for a, b in zip(ops.rwkv6_scan(r, k, v, w, u, s0, backend="ref"),
                    rwkv6_scan_ref(r, k, v, w, u, s0)):
        assert torch.equal(a, b)
    ssd_in = [torch.as_tensor(a) for a in _ssd_inputs(1, 8, 2, 4, 3,
                                                      ("ops",))]
    for a, b in zip(ops.mamba2_ssd(*ssd_in, chunk=4, backend="ref"),
                    mamba2_ssd_ref(*ssd_in, 4)):
        assert torch.equal(a, b)
    for call in (lambda: ops.flash_attention(q, q, q, backend="pallas"),
                 lambda: ops.rwkv6_scan(r, k, v, w, u, backend="x"),
                 lambda: ops.mamba2_ssd(*ssd_in, backend="interpret")):
        with pytest.raises(ValueError):
            call()


# ------------------------------ on the card ---------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernel has no CPU "
                    "mode (its plain version is tested above)")
    return torch.device("cuda")


# dp_clip_noise / quantize_decompress on the card: every instance, at and
# one past each _variant boundary (4,096 and 262,144), the main path and
# Vehicle-1, 64 clients of a 262K-parameter model, a long odd row, and a
# row too short for one 16-byte load. Row 0 is all zeros.
GPU_ROWS = [(16, 210), (23, 202), (1, 3), (3, 4096), (3, 4097), (5, 4099),
            (3, 100_003), (2, 262_144), (64, 262_144), (2, 262_145)]


def _gpu_rows(rows, n, device, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, n))
         * np.logspace(-4, 1, rows)[:, None]).astype(np.float32)
    x[0] = 0.0                                   # an all-zero row
    return torch.as_tensor(x).to(device), rng


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", GPU_ROWS)
@pytest.mark.parametrize("with_noise", [True, False])
def test_cuda_kernel_matches_plain_version(cuda_device, rows, n, with_noise):
    tg, rng = _gpu_rows(rows, n, cuda_device, seed=n)
    tn = torch.as_tensor(rng.normal(size=(rows, n)).astype(np.float32)).to(
        cuda_device) if with_noise else None
    ts = torch.as_tensor(rng.uniform(0.1, 2.0, size=rows).astype(
        np.float32)).to(cuda_device)
    before = dp_clip_noise.launches
    y, norm = dp_clip_noise(tg, tn, 1.0, ts)
    torch.cuda.synchronize()
    assert dp_clip_noise.launches == before + 1
    assert dp_clip_noise.last_variant == _row_variant(rows, n)
    wy, wn = dp_clip_noise_ref(tg, tn, 1.0, ts)
    torch.testing.assert_close(y, wy, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(norm, wn, atol=0, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", GPU_ROWS)
@pytest.mark.parametrize("bits", [1, 4, 8, 16])
def test_cuda_quantize_decompress_equals_plain_version_bitwise(cuda_device,
                                                               rows, n, bits):
    tx, rng = _gpu_rows(rows, n, cuda_device, seed=n + bits)
    tu = torch.as_tensor(rng.uniform(size=(rows, n)).astype(np.float32)).to(
        cuda_device)
    before = quantize_decompress.launches
    y, scale = quantize_decompress(tx, tu, bits)
    torch.cuda.synchronize()
    assert quantize_decompress.launches == before + 1
    assert quantize_decompress.last_variant == _row_variant(rows, n)
    wy, ws = quantize_decompress_ref(tx, tu, bits)
    assert torch.equal(scale, ws)
    assert torch.equal(y, wy)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [210, 4099, 100_003, 262_145])
def test_cuda_dp_clip_noise_takes_strided_noise_rows(cuda_device, n):
    """Step t of a (C, tau, N) noise block, a view whose rows start at other
    16-byte phases than g's and y's (the 4-byte path), equals its copy."""
    tg, rng = _gpu_rows(4, n, cuda_device, seed=n)
    block = torch.as_tensor(rng.normal(size=(4, 3, n)).astype(
        np.float32)).to(cuda_device)
    ts = torch.full((4,), 0.7, device=cuda_device)
    got = dp_clip_noise(tg, block[:, 1], 1.0, ts)
    want = dp_clip_noise(tg, block[:, 1].contiguous(), 1.0, ts)
    plain = dp_clip_noise_ref(tg, block[:, 1], 1.0, ts)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    torch.testing.assert_close(got[0], plain[0], atol=1e-6, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [210, 4097, 100_003, 262_145])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_cuda_row_kernels_take_rows_at_any_4_byte_offset(cuda_device, n,
                                                         offset):
    """Contiguous views ``offset`` floats past an aligned base: g / x at one
    16-byte phase, noise at another, y at a third (the wrapper's own,
    aligned): the kernels' 4-byte paths agree with the plain versions."""
    tx, rng = _gpu_rows(3, n, cuda_device, seed=offset)
    buf = torch.empty(3 * n + 4, device=cuda_device)
    xv = buf[offset:offset + 3 * n].view(3, n)
    xv.copy_(tx)
    nbuf = torch.empty(3 * n + 4, device=cuda_device)
    noise = nbuf[3 - offset:3 - offset + 3 * n].view(3, n)
    noise.copy_(torch.as_tensor(rng.normal(size=(3, n)).astype(
        np.float32)))
    ts = torch.full((3,), 0.3, device=cuda_device)
    y, norm = dp_clip_noise(xv, noise, 1.0, ts)
    wy, wn = dp_clip_noise_ref(xv, noise, 1.0, ts)
    torch.testing.assert_close(y, wy, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(norm, wn, atol=0, rtol=1e-5)
    u = noise.abs().remainder(1.0)
    y, scale = quantize_decompress(xv, u.contiguous(), 8)
    wy, ws = quantize_decompress_ref(xv, u, 8)
    assert torch.equal(y, wy) and torch.equal(scale, ws)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", [(16, 210), (3, 100_003), (2, 262_145)])
def test_cuda_row_kernels_are_deterministic(cuda_device, rows, n):
    """Two calls on one input are bitwise equal: every instance takes its
    reduction in one fixed order."""
    tx, rng = _gpu_rows(rows, n, cuda_device, seed=7)
    tz = torch.as_tensor(rng.uniform(size=(rows, n)).astype(np.float32)).to(
        cuda_device)
    ts = torch.full((rows,), 0.5, device=cuda_device)
    for first, second in ((dp_clip_noise(tx, tz, 1.0, ts),
                           dp_clip_noise(tx, tz, 1.0, ts)),
                          (quantize_decompress(tx, tz, 8),
                           quantize_decompress(tx, tz, 8))):
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_row_kernels_replay_in_a_cuda_graph(cuda_device):
    """One dp_clip_noise and one quantize_decompress call at the main path's
    (16, 210), captured with torch.cuda.graph and replayed, equal the eager
    calls bitwise: one launch a call, no scratch and no host sync, so a
    round can be captured. The counters count at capture, not at replay."""
    tg, rng = _gpu_rows(16, 210, cuda_device, seed=3)
    tn, tu = (torch.as_tensor(rng.uniform(size=(16, 210)).astype(
        np.float32)).to(cuda_device) for _ in range(2))
    ts = torch.full((16,), 0.9, device=cuda_device)
    eager = (dp_clip_noise(tg, tn, 1.0, ts), quantize_decompress(tg, tu, 8))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                # warm-up, as capture wants
        dp_clip_noise(tg, tn, 1.0, ts)
        quantize_decompress(tg, tu, 8)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (dp_clip_noise.launches, quantize_decompress.launches)
    with torch.cuda.graph(graph):
        captured = (dp_clip_noise(tg, tn, 1.0, ts),
                    quantize_decompress(tg, tu, 8))
    assert (dp_clip_noise.launches, quantize_decompress.launches) == (
        before[0] + 1, before[1] + 1)
    for _ in range(2):
        for out in captured:
            for t in out:
                t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            for a, b in zip(got, want):
                assert torch.equal(a, b)


# dtypes x row lengths: 16-, 8-, 4-, 2- and 1-byte copies, rows shorter than
# one vector, and rows that span several blocks
GPU_COHORT_DTYPES = [torch.float32, torch.bfloat16, torch.int32, torch.uint8,
                     torch.float64, torch.int16]
GPU_COHORT_D = [1, 5, 33, 40, 42, 130, 4099]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_COHORT_DTYPES,
                         ids=[str(t).split(".")[1] for t in GPU_COHORT_DTYPES])
@pytest.mark.parametrize("d", GPU_COHORT_D)
def test_cuda_cohort_gather_scatter_equals_plain_version_bitwise(cuda_device,
                                                                 dtype, d):
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    s, k = 37, 11
    cache = torch.randint(0, 255, (s, d), generator=gen, device=cuda_device,
                          dtype=torch.uint8)
    cache = torch.randn((s, d), generator=gen, device=cuda_device).to(dtype) \
        if dtype.is_floating_point else cache.to(dtype)
    slots = torch.randperm(s, generator=gen, device=cuda_device)[:k]
    rows = cache[torch.randperm(s, generator=gen, device=cuda_device)[:k]] \
        .flip(1).contiguous()
    for sl in (slots, slots.to(torch.int32)):
        before = cohort_gather_scatter.launches
        got = cohort_gather_scatter(cache, sl)
        assert cohort_gather_scatter.launches == before + 1
        assert torch.equal(got, cohort_gather_scatter_ref(cache, sl))
        mine, plain = cache.clone(), cache.clone()
        ptr = mine.data_ptr()
        out = cohort_gather_scatter(mine, sl, rows)
        torch.cuda.synchronize()
        assert out is mine and mine.data_ptr() == ptr
        cohort_gather_scatter_ref(plain, sl, rows)
        assert torch.equal(mine, plain)
        untouched = torch.ones(s, dtype=torch.bool, device=cuda_device)
        untouched[sl.long()] = False
        assert torch.equal(mine[untouched], cache[untouched])


@pytest.mark.gpu
def test_cuda_cohort_unaligned_pointers_take_narrower_copies(cuda_device):
    """Contiguous views at odd offsets still copy exactly (the kernel drops
    to the widest width the pointers allow)."""
    from repro_torch.kernels.cohort_gather_scatter import vector_width
    big = torch.arange(9 * 41, dtype=torch.float32,
                       device=cuda_device).reshape(9, 41)
    cache = big.reshape(-1)[1:1 + 8 * 40].reshape(8, 40)    # 4-byte aligned
    rows = torch.arange(3 * 40, dtype=torch.float32,
                        device=cuda_device).reshape(3, 40) * -1
    slots = torch.tensor([6, 0, 3], device=cuda_device)
    assert vector_width(cache, rows) == 4
    assert torch.equal(cohort_gather_scatter(cache, slots),
                       cohort_gather_scatter_ref(cache, slots))
    want = cache.clone()
    cohort_gather_scatter_ref(want, slots, rows)
    cohort_gather_scatter(cache, slots, rows)
    torch.cuda.synchronize()
    assert torch.equal(cache, want)
    aligned = torch.empty((8, 40), device=cuda_device)
    assert vector_width(aligned, rows) == 16


def _cohort_traps(slot_dtype: str) -> tuple[int, str]:
    """(exit code, stderr) of a child process that gathers slot 4 of a 4-row
    cache with ``slot_dtype`` slots and synchronises: 3 when the
    synchronisation raises (a trap ends the CUDA context, hence the
    child)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    import repro_torch
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    code = ("import torch\n"
            "from repro_torch.kernels.cohort_gather_scatter import "
            "cohort_gather_scatter as f\n"
            "c = torch.zeros((4, 8), device='cuda')\n"
            f"f(c, torch.tensor([1, 4], dtype=torch.{slot_dtype}, "
            "device='cuda'))\n"
            "try:\n"
            "    torch.cuda.synchronize()\n"
            "except RuntimeError:\n"
            "    import os\n"
            "    os._exit(3)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": src})
    return proc.returncode, proc.stderr[-2000:]


@pytest.mark.gpu
def test_cuda_cohort_out_of_range_slot_traps(cuda_device):
    """A slot outside [0, S) never touches memory past the cache: the
    kernel traps and the next synchronisation raises (in a child process,
    since a trap ends the CUDA context)."""
    code, err = _cohort_traps("int64")
    assert code == 3, err


@pytest.mark.gpu
def test_cuda_cohort_int32_out_of_range_slot_traps(cuda_device):
    """The same trap where the kernel reads int32 slots."""
    code, err = _cohort_traps("int32")
    assert code == 3, err


@pytest.mark.gpu
@pytest.mark.parametrize("scatter", [False, True], ids=["gather", "scatter"])
def test_cuda_cohort_int32_slots_launch_one_kernel_and_no_cast(cuda_device,
                                                               scatter):
    """int32 slots (the resident driver's) go to the kernel as they are:
    bitwise the plain version, one count on the counter, and one kernel on
    the device (no int64 cast kernel before it) where the profiler traces
    the card."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    cache = torch.randn((256, 42), generator=gen, device=cuda_device)
    rows = torch.randn((16, 42), generator=gen, device=cuda_device)
    slots = torch.randperm(256, generator=gen, device=cuda_device)[:16] \
        .to(torch.int32)
    mine, plain = cache.clone(), cache.clone()
    cohort_gather_scatter(mine, slots, rows if scatter else None)  # build
    torch.cuda.synchronize()
    before = cohort_gather_scatter.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = cohort_gather_scatter(mine, slots, rows if scatter else None)
        torch.cuda.synchronize()
    assert cohort_gather_scatter.launches == before + 1
    want = cohort_gather_scatter_ref(plain, slots, rows if scatter else None)
    assert torch.equal(got, want)
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.device_time_total > 0]
    if kernels:                      # the profiler traced the card
        assert sum(e.count for e in kernels) == 1, [e.key for e in kernels]
        assert "copy_rows" in kernels[0].key


# flash_attention / rwkv6_scan / mamba2_ssd on the card: the CPU tests'
# shapes and chip_smoke.py's phase-10 shapes (gemma3's prefill with and
# without its window, zamba2's shared attention, rwkv6's prefill and decode
# step, zamba2's SSD). f32 against the plain version, bf16 against the plain
# version run in f32 on the same bf16 values (the kernels compute in f32 and
# round the output once; the plain flash version would round its scores
# too). Tolerance: the two sum in another order, which moves an output by up
# to ~1e-5 of the output tensor's largest magnitude (sums of up to 128
# terms of size ~|max|; the SSD's outputs reach ~100 at zamba2's shape), so
# atol = 1e-5 * max(1, max|plain|); rtol 1e-4 in f32, and 8e-3 (two bf16
# ulps, 2^-7) where the output is rounded to bf16.
# The bf16 cases at hd a multiple of 16 run the tensor-core instance, the
# others the SIMT one (bf16 at hd 40 holds the SIMT instance in bf16). Added
# for it: hd 128 at S 2048 (codeqwen, granite, internvl, mistral), a ragged
# last q tile of one (b, h) next to the next one's rows, a window narrower
# than its 64-key tile, and every tensor-core instance (hd 16..256, one to
# four boxes of 64 columns, the last one partly past hd) on a ragged S of
# three q tiles.
GPU_FLASH = [(b, h, s, hd, w) for b, h, s, hd, w, _ in FLASH_CASES] + [
    (2, 8, 2048, 256, 0), (2, 8, 2048, 256, 1024), (2, 32, 512, 112, 0),
    (1, 4, 2048, 128, 0), (1, 2, 45, 40, 0), (2, 3, 77, 64, 0),
    (1, 2, 200, 128, 20)] + [(2, 2, 150, hd, w) for hd in range(16, 257, 16)
                             for w in (0, 70)]
# rwkv6: the CPU cases (each from zero and from s0), rwkv6-1.6b's prefill
# at batch 2 and 1 and at S 2048, its decode step (S = 1 from s0, SIMT); in
# bf16 the tensor-core instance on a ragged S of three chunks from s0 at hd
# 64, 32 and 48, the model's decay, a strong one (L falls ~290 a chunk)
# and w with exact zeros and ones.
GPU_RWKV = [(b, h, s, hd, s0, "sigmoid") for b, h, s, hd in RWKV_CASES
            for s0 in (False, True)] + [
    (2, 32, 512, 64, False, "sigmoid"), (2, 32, 1, 64, True, "sigmoid"),
    (1, 32, 512, 64, False, "sigmoid"), (2, 32, 2048, 64, False, "sigmoid"),
    (2, 3, 150, 64, True, "sigmoid"), (2, 3, 150, 32, True, "sigmoid"),
    (2, 3, 150, 48, False, "sigmoid"), (2, 32, 512, 64, True, "model"),
    (2, 4, 512, 64, True, "strong"), (2, 3, 150, 64, True, "edges")]
# The SSD's bf16 cases at Q 64 / 128 with P and N multiples of 16 run the
# tensor-core instance, all others the SIMT one: zamba2's prefill at batch
# 2 (two chains per block) and batch 1 (one), its 16-chunk S 2048, Q 64
# with P and N below one 64-column box, P and N of two boxes (one stage),
# widths that end inside a box, and an odd head count split in pairs
# (B * H above the SM count), whose last block runs one chain. P = N = 128
# at Q 128 (two boxes each, one stage) runs in bf16 only: the SIMT tiles
# of that shape exceed shared memory, so f32 raises there.
GPU_SSD = [c for c in SSD_CASES] + [
    (2, 512, 112, 64, 64, 128), (1, 512, 112, 64, 64, 128),
    (2, 2048, 112, 64, 64, 128), (2, 256, 4, 32, 16, 64),
    (2, 256, 3, 128, 128, 64), (2, 128, 3, 80, 48, 64),
    (1, 256, 135, 16, 16, 64)]


def _gpu_close(got, want, dtype):
    """``got`` (the kernel's output, in ``dtype``) against ``want`` (the
    plain version in f32) at the tolerance above."""
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(
        got.float(), want, atol=1e-5 * scale,
        rtol=1e-4 if dtype == torch.float32 else 8e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,hd,window", GPU_FLASH,
                         ids=[f"b{c[0]}h{c[1]}s{c[2]}d{c[3]}w{c[4]}"
                              for c in GPU_FLASH])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_flash_attention_matches_plain_version(cuda_device, b, h, s, hd,
                                                    window, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(s + hd + window)
    q, k, v = (torch.randn((b, h, s, hd), generator=gen, device=cuda_device)
               .to(dtype) for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert flash_attention.last_variant == (
        "tc" if dtype == torch.bfloat16 and hd % 16 == 0 else "simt")
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_ref(q.float(), k.float(), v.float(),
                               window=window)
    _gpu_close(got, want, dtype)


@pytest.mark.gpu
def test_cuda_flash_tc_refuses_a_misaligned_view(cuda_device):
    shape = (1, 2, 33, 64)
    n = 2 * 33 * 64
    buf = torch.randn(n + 1, device=cuda_device).to(torch.bfloat16)
    q = buf[1:].view(shape)                  # 2 bytes past an aligned base
    k, v = (torch.randn(shape, device=cuda_device).to(torch.bfloat16)
            for _ in range(2))
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    before = flash_attention.launches
    for args in ((q, k, v), (k, q, v), (k, v, q)):
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention(*args)
    assert flash_attention.launches == before
    aligned = q.clone()
    _gpu_close(flash_attention(aligned, k, v),
               flash_attention_ref(aligned.float(), k.float(), v.float()),
               torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,hd,with_s0,decay", GPU_RWKV,
                         ids=[f"b{c[0]}h{c[1]}s{c[2]}d{c[3]}"
                              f"{'-s0' if c[4] else ''}"
                              f"{'' if c[5] == 'sigmoid' else '-' + c[5]}"
                              for c in GPU_RWKV])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_rwkv6_scan_matches_plain_version(cuda_device, b, h, s, hd,
                                               with_s0, decay, dtype):
    r, k, v, w, u, s0 = (None if a is None else
                         torch.as_tensor(a).to(cuda_device)
                         for a in _rwkv_inputs(b, h, s, hd, with_s0,
                                               ("gpu", b, h, s, hd), decay))
    r, k, v = (t.to(dtype) for t in (r, k, v))
    before = rwkv6_scan.launches
    y, st = rwkv6_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == before + 1
    assert rwkv6_scan.last_variant == _rwkv_variant(s, hd, dtype)
    assert y.dtype == dtype and st.dtype == torch.float32
    wy, ws = rwkv6_scan_ref(r.float(), k.float(), v.float(), w, u, s0)
    _gpu_close(y, wy, dtype)
    _gpu_close(st, ws, torch.float32)


@pytest.mark.gpu
def test_cuda_rwkv6_scan_tc_refuses_a_misaligned_view(cuda_device):
    r, k, v, w, u, s0 = (torch.as_tensor(a).to(cuda_device) for a in
                         _rwkv_inputs(1, 2, 130, 64, True, ("misaligned",)))
    r, k, v = (t.to(torch.bfloat16) for t in (r, k, v))
    buf = torch.empty(k.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
    shifted = buf[1:].view(k.shape)              # 2 bytes past an aligned base
    shifted.copy_(k)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    before = rwkv6_scan.launches
    for args in ((shifted, k, v, w), (r, shifted, v, w), (r, k, shifted, w)):
        with pytest.raises(ValueError, match="16-byte"):
            rwkv6_scan(*args, u, s0)
    assert rwkv6_scan.launches == before
    y, st = rwkv6_scan(r, shifted.clone(), v, w, u, s0)
    assert rwkv6_scan.last_variant == "tc"
    wy, ws = rwkv6_scan_ref(r.float(), k.float(), v.float(), w, u, s0)
    _gpu_close(y, wy, torch.bfloat16)
    _gpu_close(st, ws, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,n,chunk", GPU_SSD,
                         ids=[f"b{c[0]}s{c[1]}h{c[2]}p{c[3]}n{c[4]}q{c[5]}"
                              for c in GPU_SSD])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_mamba2_ssd_matches_plain_version(cuda_device, b, s, h, p, n,
                                               chunk, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, dt, a, b_in, c_in = (torch.as_tensor(t).to(cuda_device) for t in
                            _ssd_inputs(b, s, h, p, n, ("gpu", b, s, h)))
    x, b_in, c_in = (t.to(dtype) for t in (x, b_in, c_in))
    before = mamba2_ssd.launches
    y, st = mamba2_ssd(x, dt, a, b_in, c_in, chunk=chunk)
    torch.cuda.synchronize()
    assert mamba2_ssd.launches == before + 1
    assert mamba2_ssd.last_variant == _ssd_variant(min(chunk, s), p, n,
                                                   dtype)
    assert y.dtype == dtype and st.shape == (b, h, p, n)
    wy, ws = mamba2_ssd_ref(x.float(), dt, a, b_in.float(), c_in.float(),
                            min(chunk, s))
    _gpu_close(y, wy, dtype)
    _gpu_close(st, ws, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("p,n", [(128, 128), (64, 128), (128, 64)])
def test_cuda_mamba2_ssd_tc_two_box_widths_at_chunk_128(cuda_device, p, n):
    x, dt, a, b_in, c_in = (torch.as_tensor(t).to(cuda_device) for t in
                            _ssd_inputs(2, 256, 3, p, n, ("gpu-wide", p, n)))
    with pytest.raises(ValueError):
        mamba2_ssd(x, dt, a, b_in, c_in, chunk=128)
    x, b_in, c_in = (t.to(torch.bfloat16) for t in (x, b_in, c_in))
    y, st = mamba2_ssd(x, dt, a, b_in, c_in, chunk=128)
    torch.cuda.synchronize()
    assert mamba2_ssd.last_variant == "tc"
    wy, ws = mamba2_ssd_ref(x.float(), dt, a, b_in.float(), c_in.float(),
                            128)
    _gpu_close(y, wy, torch.bfloat16)
    _gpu_close(st, ws, torch.float32)


@pytest.mark.gpu
def test_cuda_mamba2_ssd_tc_refuses_a_misaligned_view(cuda_device):
    x, dt, a, b_in, c_in = (torch.as_tensor(t).to(cuda_device) for t in
                            _ssd_inputs(1, 128, 2, 64, 64, ("misaligned",)))
    x, b_in, c_in = (t.to(torch.bfloat16) for t in (x, b_in, c_in))
    buf = torch.empty(b_in.numel() + 1, dtype=torch.bfloat16,
                      device=cuda_device)
    shifted = buf[1:].view(b_in.shape)           # 2 bytes past an aligned base
    shifted.copy_(b_in)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    before = mamba2_ssd.launches
    with pytest.raises(ValueError, match="16-byte"):
        mamba2_ssd(x, dt, a, shifted, c_in, chunk=64)
    assert mamba2_ssd.launches == before
    y, st = mamba2_ssd(x, dt, a, shifted.clone(), c_in, chunk=64)
    wy, ws = mamba2_ssd_ref(x.float(), dt, a, b_in.float(), c_in.float(), 64)
    _gpu_close(y, wy, torch.bfloat16)
    _gpu_close(st, ws, torch.float32)


@pytest.mark.gpu
def test_cuda_model_kernel_wrappers_refuse_grad_inputs(cuda_device):
    for kernel in ("flash", "rwkv", "ssd"):
        fn, args = _kernel_call(kernel, "grad")
        with pytest.raises(ValueError):
            fn(*(a.to(cuda_device) for a in args))


if __name__ == "__main__":
    # the max |torch - jax| of the plain version against the Pallas kernel
    # (interpret) and the jnp reference over the cases above:
    # PYTHONPATH=src python tests/test_torch_kernels.py
    gaps = {"pallas interpret": [0.0, 0.0], "jnp ref": [0.0, 0.0]}
    for rows, n, scale in ((1, 1, 3.0), (3, 37, 1.0), (5, 1000, 0.05),
                           (4, 5003, 10.0)):
        g, noise, sigma = _rows(rows, n, scale, seed=rows * 7 + n)
        for with_noise in (True, False):
            tg, tn, ts = _torch(g, noise, sigma)
            y, norm = dp_clip_noise(tg, tn if with_noise else None, 1.0, ts)
            for r in range(rows):
                nz = jnp.asarray(noise[r]) if with_noise else None
                for name, (wy, wn) in (
                        ("pallas interpret", jax_dp_clip_noise(
                            jnp.asarray(g[r]), nz, 1.0, float(sigma[r]),
                            block=256, interpret=True)),
                        ("jnp ref", jref.dp_clip_noise_ref(
                            jnp.asarray(g[r]), nz, 1.0, float(sigma[r])))):
                    gaps[name][0] = max(gaps[name][0], float(np.max(np.abs(
                        y[r].numpy() - np.asarray(wy)))))
                    gaps[name][1] = max(gaps[name][1], abs(
                        float(norm[r]) / float(wn) - 1.0))
    for name, (dy, dn) in gaps.items():
        print(f"plain dp_clip_noise vs {name}: max|dy| = {dy:.3e}, "
              f"max rel|dnorm| = {dn:.3e}")
    # the same for the model kernels' plain versions, f32, over the cases
    # of their tests above
    gaps = {}

    def gap(name, got, want):
        gaps[name] = max(gaps.get(name, 0.0),
                         float(np.max(np.abs(_f32(got) - _f32(want)))))

    for b, h, s, hd, window, block in FLASH_CASES:
        rng = _np_rng("flash", b, h, s, hd)
        qkv = [rng.normal(size=(b, h, s, hd)).astype(np.float32)
               for _ in range(3)]
        got = ops.flash_attention(*map(torch.as_tensor, qkv), window=window)
        jqkv = [jnp.asarray(a) for a in qkv]
        gap("flash vs pallas interpret", got, jax_flash_attention(
            *jqkv, window=window, block_q=block, block_k=block,
            interpret=True))
        gap("flash vs jnp ref", got,
            jref.flash_attention_ref(*jqkv, window=window))
    for b, h, s, hd in RWKV_CASES:
        for with_s0 in (False, True):
            r, k, v, w, u, s0 = _rwkv_inputs(b, h, s, hd, with_s0,
                                             (b, h, s, hd))
            y, st = ops.rwkv6_scan(
                *(torch.as_tensor(a) for a in (r, k, v, w, u)),
                None if s0 is None else torch.as_tensor(s0))
            jin = [jnp.asarray(a) for a in (r, k, v, w, u)] + [
                None if s0 is None else jnp.asarray(s0)]
            for name, (wy, ws) in (
                    ("pallas interpret", jax_rwkv6_scan(*jin,
                                                        interpret=True)),
                    ("jnp ref", jref.rwkv6_scan_ref(*jin))):
                gap(f"rwkv6_scan y vs {name}", y, wy)
                gap(f"rwkv6_scan state vs {name}", st, ws)
    for b, s, h, p, n, chunk in SSD_CASES:
        ins = _ssd_inputs(b, s, h, p, n, (b, s, h, p, n))
        y, st = ops.mamba2_ssd(*map(torch.as_tensor, ins), chunk=chunk)
        jin = [jnp.asarray(a) for a in ins]
        for name, (wy, ws) in (
                ("pallas interpret", jax_mamba2_ssd(*jin, chunk=chunk,
                                                    interpret=True)),
                ("sequential ref", jref.mamba2_ssd_ref(*jin)),
                ("ssd_chunked", jax_ssd_chunked(*jin, chunk=min(chunk, s)))):
            gap(f"mamba2_ssd y vs {name}", y, wy)
            gap(f"mamba2_ssd state vs {name}", st, ws)
    for name, g in gaps.items():
        print(f"plain {name}: max|d| = {g:.3e}")
    # the share of the card's tolerance the tensor-core WKV emulation uses
    # against the plain version, per decay regime, over its test's cases
    for decay in ("sigmoid", "model", "strong", "edges"):
        use = [0.0, 0.0]
        for b, h, s, hd in WKV_EMULATION_CASES:
            for with_s0 in (False, True):
                r, k, v, w, u, s0 = _rwkv_inputs(b, h, s, hd, with_s0,
                                                 ("emu", b, h, s, hd), decay)
                r, k, v = (torch.as_tensor(t).to(torch.bfloat16)
                           for t in (r, k, v))
                w, u = torch.as_tensor(w), torch.as_tensor(u)
                s0 = None if s0 is None else torch.as_tensor(s0)
                y, st = _wkv_tc_emulation(r, k, v, w, u, s0)
                wy, ws = rwkv6_scan_ref(r.float(), k.float(), v.float(), w,
                                        u, s0)
                use = [max(use[0], _kernel_tol_use(y, wy, 8e-3)),
                       max(use[1], _kernel_tol_use(st, ws, 1e-4))]
        print(f"wkv tc emulation, {decay} decay: y uses {use[0]:.3f}, the "
              f"state {use[1]:.3f} of the card's tolerance")
