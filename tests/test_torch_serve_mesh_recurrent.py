"""The serving route on the serving mesh (1, 2) for the recurrent and MoE
archs, against the JAX package and the port's whole route, on the CPU at
smoke widths in f32 with JAX's own weights
(tests/_torch_serve_mesh_jax.py's gates, as in
tests/test_torch_serve_mesh.py):

* rwkv6-1.6b: the WKV on each rank's heads (4 of 8 heads of 32) with its
  rows of ``bonus_u``, from and into its rows of the ``wkv`` cache; the
  token-shift rows ``tm_last`` / ``cm_last`` whole;
* zamba2-7b: Mamba2's prefill and decode on each rank's heads of the SSD
  (its rows of ``h``), the conv window whole; the shared attention with
  its LoRA deltas on the rank's heads;
* phi3.5-moe: expert-parallel MoE, two experts a rank.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest
from _torch_serve_mesh_jax import route_matches

from repro_torch.launch.mesh import HostWorld


@pytest.fixture(scope="module")
def world():
    w = HostWorld(2)
    yield w
    w.close()


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "zamba2-7b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_recurrent_and_moe_archs_on_the_serving_mesh_match_jax(world, name):
    route_matches(world, name)
