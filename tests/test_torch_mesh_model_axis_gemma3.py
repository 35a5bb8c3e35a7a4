"""The transformer on the model axis of the port's ``mesh_2d`` engine
(``dm > 1``), against the JAX package, in one gloo world of 4 ranks
started once for the module (the linear models' gates are in
tests/test_torch_mesh_model_axis.py).

* Placement: every weight of a gemma3 smoke variant splits where JAX's
  ``resolve_spec`` puts it at its ``shard_hint`` site under
  ``mesh2d_rules``; the embedding follows its init axes; norms stay whole.
* The round: gemma3's smoke widths (2 layers, 4 q / 2 kv heads, a sliding
  window and a full layer) as ``mesh_2d`` (1, 2) and (2, 2) against JAX's
  ``vmap`` round (tests/_torch_model_axis_jax.py: JAX's params with the
  norm scales drawn from a seed) within 2e-5 of each tensor's largest
  magnitude, the loss gradients within 4e-5, and the Eq.-7a pre-clip norm
  equal to the whole row's within 1e-6.
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


@pytest.fixture(scope="module")
def world():
    w = HostWorld(4)
    yield w
    w.close()


def _gemma_cfgs(n_kv_heads=2):
    """gemma3's smoke widths with GQA (4 q / 2 kv heads), cut to one swa
    and one full layer: both attention masks in two layers."""
    def cut(cfg, seg):
        pattern = cfg.segments[0].pattern
        return replace(cfg, n_kv_heads=n_kv_heads, n_layers=2,
                       segments=(seg(1, (pattern[0], replace(
                           pattern[0], attn_kind="full"))),))
    return (cut(jax_smoke_variant(jax_get_arch("gemma3-4b")), JSegment),
            cut(smoke_variant(get_arch("gemma3-4b")), Segment))


def test_gemma3_placement_matches_jax_hints():
    """Every weight JAX hints at its use site splits where JAX's rules put
    it; the embedding follows its init axes ("tp", "fsdp"); the norm
    scales stay whole."""
    dims, hints = placement_matches_jax(*_gemma_cfgs())
    assert {k for _, k in hints} == {"wq", "wk", "wv", "wo", "w_gate",
                                     "w_up", "w_down"}
    for layer in dims["segments"][0].values():
        assert set(layer["norm1"].values()) == {-1}
    assert dims["embed"]["embedding"] == 0
    assert dims["final_norm"] == {"scale": -1}
    assert [dims["segments"][0][j]["mixer"]["wq"] for j in "01"] == [2, 2]


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_gemma3_round_matches_jax(world, mesh_shape):
    """gemma3's smoke widths (2 layers, 4 q / 2 kv heads, vocab 512) as
    mesh_2d ``mesh_shape`` (a (1, 2) mesh leaves two ranks outside): one
    DP round (C 2, tau 2) from JAX's weights on JAX's noise within 2e-5 of
    each tensor's largest magnitude of JAX's vmap round; the first step's
    loss gradients within 4e-5 of JAX's; the Eq.-7a pre-clip norm of each
    client equal to its whole row's within 1e-6; the ranks' gradients
    alike."""
    round_matches_jax(world, "gemma3-4b", *_gemma_cfgs(), mesh_shape)
