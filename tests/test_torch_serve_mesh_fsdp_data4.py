"""Weights split over a data axis of 4 ranks (the serving mesh (4, 1):
no model axis, every weight's data split on the dim the JAX package's
``serve_rules(fsdp_over_data=True)`` names), on the CPU at smoke widths in
f32 with JAX's own weights, B 4 (one row a data rank): gemma3-4b,
phi3.5-moe, rwkv6 and zamba2 held against JAX and the whole route as
tests/test_torch_serve_mesh_fsdp.py holds the (2, 2) mesh.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest
from test_torch_serve_mesh_fsdp import FAMILIES, fsdp_route


@pytest.fixture(scope="module")
def world():
    from repro_torch.launch.mesh import HostWorld
    w = HostWorld(4)
    yield w
    w.close()


@pytest.mark.parametrize("name", FAMILIES)
def test_weights_over_a_data_axis_of_4_match_jax(world, name):
    fsdp_route(world, name, (4, 1), batch=4)
