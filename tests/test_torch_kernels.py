"""The port's kernel modules (``dp_clip_noise``, ``quantize_decompress``)
against the JAX package.

On the CPU a wrapper runs its kernel's plain version, so here the plain
``dp_clip_noise`` is held against JAX's Pallas kernel (interpret mode) and
its jnp reference on the same numpy-seeded inputs, at atol 1e-6 (sums taken
in another order); the plain ``quantize_decompress`` is held bit for bit
against JAX in ``tests/test_torch_aggregation.py``. The hand-written CUDA
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
    from repro.kernels.dp_clip_noise import dp_clip_noise as jax_dp_clip_noise
    from repro.kernels.ops import dp_clip_noise_tree as jax_dp_clip_noise_tree
except ModuleNotFoundError:
    jax = None

from repro_torch.kernels.dp_clip_noise import dp_clip_noise
from repro_torch.kernels.ops import (
    dp_clip_noise_tree,
    quantize_decompress_rows,
)
from repro_torch.kernels.quantize_decompress import quantize_decompress
from repro_torch.kernels.ref import dp_clip_noise_ref, quantize_decompress_ref

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
