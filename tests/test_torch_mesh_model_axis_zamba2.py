"""Mamba2 and zamba2's shared block on the model axis of the port's
``mesh_2d`` engine (``dm > 1``), against the JAX package, in one gloo
world of 4 ranks started once for the module.

* Placement: every leaf of the zamba2-7b smoke variant splits where JAX's
  ``resolve_spec`` puts it under ``mesh2d_rules``: Mamba2's ``w_in`` on its
  d_model rows, ``conv_w`` on its channels, the per-head scalars on heads,
  ``norm_scale`` on d_inner, ``w_out`` on its rows; the shared attention
  and MLP as the dense ones; each invocation's LoRA factors on d_model or
  heads (``lora_q_a`` / ``lora_o_b`` on d_model, ``lora_q_b`` /
  ``lora_o_a`` on heads).
* The round: the smoke widths (16 SSD heads of 32, 544 conv channels, 4
  attention heads) cut to one ``shared_attn`` and one ``mamba2`` layer,
  from JAX's params with the zero LoRA factors (and every other constant
  leaf) drawn from a seed, as ``mesh_2d`` (1, 2) and (2, 2) against JAX's
  ``vmap`` round: params within 2e-5, loss gradients within 4e-5, the
  Eq.-7a pre-clip norm within 1e-6, whole leaves equal on every model
  rank.
"""
from dataclasses import replace

import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest
from _torch_model_axis_jax import placement_matches_jax, round_matches_jax

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke_variant
from repro.configs.base import Segment as JSegment
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.configs.base import Segment
from repro_torch.launch.mesh import HostWorld

ARCH = "zamba2-7b"


@pytest.fixture(scope="module")
def world():
    w = HostWorld(4)
    yield w
    w.close()


def _cfgs():
    """The smoke widths cut to one shared-attention and one Mamba2 layer."""
    def cut(cfg, seg):
        shared, mamba = cfg.segments[0].pattern[:2]
        assert (shared.mixer, mamba.mixer) == ("shared_attn", "mamba2")
        return replace(cfg, n_layers=2, segments=(seg(1, (shared, mamba)),))
    return (cut(jax_smoke_variant(jax_get_arch(ARCH)), JSegment),
            cut(smoke_variant(get_arch(ARCH)), Segment))


def test_zamba2_placement_matches_jax_hints():
    dims, hints = placement_matches_jax(*_cfgs())
    assert {k for m, k in hints if m == "repro.models.ssm"} == {"w_out"}
    lora, ssm = (dims["segments"][0][j]["mixer"] for j in "01")
    assert {k: d - 1 for k, d in lora.items()} == {
        "lora_q_a": 0, "lora_q_b": 1, "lora_o_a": 0, "lora_o_b": 1}
    assert {k: d - 1 for k, d in ssm.items()} == {
        "w_in": 0, "conv_w": 1, "a_log": 0, "dt_bias": 0, "d_skip": 0,
        "norm_scale": 0, "w_out": 0}
    assert dims["shared"] == {
        "attn": {"wq": 1, "wk": 1, "wv": 1, "wo": 0},
        "mlp": {"w_gate": 1, "w_up": 1, "w_down": 0}}


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_zamba2_round_matches_jax(world, mesh_shape):
    round_matches_jax(world, ARCH, *_cfgs(), mesh_shape)


def test_ssd_chunked_is_finite_at_zamba2s_chunk():
    """The training route's SSD at zamba2-7b's chunk of 128, f32, with
    softplus steps as its full-width projections give them: the JAX
    package's ``ssd_chunked`` overflows above the causal mask (exp(l_t -
    l_s) past f32's range, times 0: NaN, a reference fault); the port's
    masks the exponent first, so its output and gradients are finite and
    equal the kernel's plain version (which zamba2's serving runs)."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.models.ssm import ssd_chunked as jax_ssd_chunked
    from repro_torch.kernels.ref import mamba2_ssd_ref
    from repro_torch.models.ssm import ssd_chunked
    chunk = get_arch(ARCH).ssd_chunk
    assert chunk == 128
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 2 * chunk, 2, 4, 8
    x, raw, b_in, c_in = (rng.standard_normal(shape).astype(np.float32)
                          for shape in ((b, s, h, p), (b, s, h), (b, s, n),
                                        (b, s, n)))
    dt = np.log1p(np.exp(raw))                              # softplus
    a = -np.ones(h, np.float32)
    jy, _ = jax_ssd_chunked(*(jnp.asarray(t) for t in (x, dt, a, b_in,
                                                        c_in)), chunk=chunk)
    assert np.isnan(np.asarray(jy)).any()
    args = [torch.as_tensor(t) for t in (x, dt, a, b_in, c_in)]
    args[0].requires_grad_(True)
    y, h_final = ssd_chunked(*args, chunk=chunk)
    want, want_h = mamba2_ssd_ref(*(t.detach() for t in args), chunk)
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h_final, want_h, rtol=1e-4, atol=1e-4)
    (g,) = torch.autograd.grad(torch.sum(y * torch.sin(y)), args[0])
    assert torch.isfinite(g).all()
