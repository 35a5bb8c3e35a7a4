"""RWKV6 (time mix and channel mix) on the model axis of the port's
``mesh_2d`` engine (``dm > 1``), against the JAX package, in one gloo
world of 4 ranks started once for the module.

* Placement: every leaf of the rwkv6-1.6b smoke variant splits where JAX's
  ``resolve_spec`` puts it under ``mesh2d_rules`` (its use-site hint, else
  its init axes): the projections and ``decay_a`` on their d_model rows,
  ``w_o`` on its rows, ``decay_b`` on its columns, ``bonus_u`` on heads,
  the channel mix's ``w_v`` on its d_ff rows; the mixes, ``decay_w0`` and
  ``ln_scale`` whole.
* The round: the smoke variant (8 heads of 32, d_ff 512) as ``mesh_2d``
  (1, 2) and (2, 2) against JAX's ``vmap`` round, from JAX's params with
  every constant leaf drawn from a seed: params within 2e-5 of each
  tensor's largest magnitude, loss gradients within 4e-5, the Eq.-7a
  pre-clip norm within 1e-6 of the whole row's, whole leaves equal on
  every model rank.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest
from _torch_model_axis_jax import placement_matches_jax, round_matches_jax

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke_variant
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.launch.mesh import HostWorld

ARCH = "rwkv6-1.6b"


@pytest.fixture(scope="module")
def world():
    w = HostWorld(4)
    yield w
    w.close()


def _cfgs():
    return (jax_smoke_variant(jax_get_arch(ARCH)),
            smoke_variant(get_arch(ARCH)))


def test_rwkv_placement_matches_jax_hints():
    dims, hints = placement_matches_jax(*_cfgs())
    assert {k for _, k in hints} == {"w_o"}
    layer = dims["segments"][0]["0"]
    tm, cm = layer["mixer"], layer["ffn"]
    # +1: the stacked layers' step axis
    assert {k: tm[k] - 1 for k in ("w_r", "w_k", "w_v", "w_g", "w_o",
                                   "decay_a", "decay_b", "bonus_u")} == {
        "w_r": 0, "w_k": 0, "w_v": 0, "w_g": 0, "w_o": 0, "decay_a": 0,
        "decay_b": 1, "bonus_u": 0}
    assert {tm[k] for k in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g",
                            "decay_w0", "ln_scale")} == {-1}
    assert {k: d - 1 for k, d in cm.items() if d >= 0} == {
        "w_k": 0, "w_v": 0, "w_r": 0}
    assert cm["mu_k"] == cm["mu_r"] == -1


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_rwkv_round_matches_jax(world, mesh_shape):
    round_matches_jax(world, ARCH, *_cfgs(), mesh_shape)
