"""Two KV heads on a model axis of four (``mesh_2d`` (1, 4)), against the
JAX package, in one gloo world of 4 ranks: the K/V projections stay whole
on every rank, and each rank's one query head must read KV head
``index // 2`` (its *global* head's group; a rank's local grouping would
read KV head 0 everywhere). One DP round of granite-20b's smoke widths
with 2 KV heads (C 2, tau 2) within 1e-5 of JAX's ``vmap`` round, as the
port's ``vmap`` round is, held as tests/test_torch_mesh_model_axis_mqa.py
holds MQA.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest
from _torch_model_axis_jax import round_and_vmap_match_jax
from _torch_serve_mesh_jax import CASES

from repro_torch.launch.mesh import HostWorld


@pytest.fixture(scope="module")
def world():
    w = HostWorld(4)
    yield w
    w.close()


def test_kv2_round_on_four_ranks_matches_jax(world):
    round_and_vmap_match_jax(world, "granite-20b-kv2",
                             *CASES["granite-20b-kv2"](), (1, 4), 1e-5)
