"""The port's kernel modules (``dp_clip_noise``, ``quantize_decompress``,
``cohort_gather_scatter``) against the JAX package.

On the CPU a wrapper runs its kernel's plain version, so here the plain
``dp_clip_noise`` is held against JAX's Pallas kernel (interpret mode) and
its jnp reference on the same numpy-seeded inputs, at atol 1e-6 (sums taken
in another order); the plain ``quantize_decompress`` is held bit for bit
against JAX in ``tests/test_torch_aggregation.py``; the plain
``cohort_gather_scatter`` bit for bit against JAX's reference and its Pallas
kernel (interpret mode) here. The hand-written CUDA
kernels themselves are held against their plain versions by the ``gpu``
tests at the end, which need a card:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

(``--noconftest`` because the suite's conftest imports jax, which a machine
that only runs the GPU tests need not have.)
"""
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
    from repro.kernels.ops import dp_clip_noise_tree as jax_dp_clip_noise_tree
except ModuleNotFoundError:
    jax = None

from repro_torch.kernels.cohort_gather_scatter import cohort_gather_scatter
from repro_torch.kernels.dp_clip_noise import dp_clip_noise
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
    quantize_decompress_ref,
)

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


def test_cohort_plain_version_refuses_out_of_range_slots():
    with pytest.raises(IndexError):
        cohort_gather(torch.zeros((4, 3)), torch.tensor([1, 4]))


# ------------------------------ on the card ---------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernel has no CPU "
                    "mode (its plain version is tested above)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", [(16, 210), (23, 202), (3, 100_003)])
@pytest.mark.parametrize("with_noise", [True, False])
def test_cuda_kernel_matches_plain_version(cuda_device, rows, n, with_noise):
    g, noise, sigma = _rows(rows, n, 1.0, seed=n)
    tg, tn, ts = (t.to(cuda_device) for t in _torch(g, noise, sigma))
    tn = tn if with_noise else None
    before = dp_clip_noise.launches
    y, norm = dp_clip_noise(tg, tn, 1.0, ts)
    torch.cuda.synchronize()
    assert dp_clip_noise.launches == before + 2
    wy, wn = dp_clip_noise_ref(tg, tn, 1.0, ts)
    torch.testing.assert_close(y, wy, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(norm, wn, atol=0, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", [(16, 210), (23, 202), (3, 100_003)])
@pytest.mark.parametrize("bits", [1, 4, 8, 16])
def test_cuda_quantize_decompress_equals_plain_version_bitwise(cuda_device,
                                                               rows, n, bits):
    rng = np.random.default_rng(n + bits)
    x = (rng.normal(size=(rows, n))
         * np.logspace(-4, 1, rows)[:, None]).astype(np.float32)
    x[0] = 0.0                                   # an all-zero row
    u = rng.uniform(size=(rows, n)).astype(np.float32)
    tx, tu = (torch.as_tensor(a).to(cuda_device) for a in (x, u))
    before = quantize_decompress.launches
    y, scale = quantize_decompress(tx, tu, bits)
    torch.cuda.synchronize()
    assert quantize_decompress.launches == before + 2
    wy, ws = quantize_decompress_ref(tx, tu, bits)
    assert torch.equal(scale, ws)
    assert torch.equal(y, wy)


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


@pytest.mark.gpu
def test_cuda_cohort_out_of_range_slot_traps(cuda_device):
    """A slot outside [0, S) never touches memory past the cache: the
    kernel traps and the next synchronisation raises (in a child process,
    since a trap ends the CUDA context)."""
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
            "f(c, torch.tensor([1, 4], device='cuda'))\n"
            "try:\n"
            "    torch.cuda.synchronize()\n"
            "except RuntimeError:\n"
            "    import os\n"
            "    os._exit(3)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": src})
    assert proc.returncode == 3, proc.stderr[-2000:]


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
