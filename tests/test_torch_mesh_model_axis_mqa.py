"""KV heads the model axis does not divide (MQA), on the model axis of
the port's ``mesh_2d`` engine (``dm > 1``), against the JAX package, in
one gloo world of 2 ranks (tests/test_torch_mesh_model_axis_kv2.py holds
a 2-KV-head variant on 4).

* Placement: ``wk`` / ``wv`` stay whole (-1) where the model axis does not
  divide their heads, as JAX's ``resolve_spec`` drops the axis on the
  whole shape; ``wq`` / ``wo`` split on their heads.
* The round: granite-20b's smoke widths (4 q heads, one KV head, a
  sliding-window and a full layer) on (1, 2): one DP round (C 2, tau 2)
  from JAX's seeded weights on JAX's noise within 1e-5 of each tensor's
  largest magnitude of JAX's ``vmap`` round, as the port's ``vmap`` round
  is; the first step's loss gradients within 4e-5 of JAX's and alike on
  both ranks (the whole K/V leaves' gradients summed over the model
  group), the Eq.-7a pre-clip norm equal to the whole row's within 1e-6
  (the whole leaves counted once).
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest
from _torch_model_axis_jax import (
    placement_matches_jax,
    round_and_vmap_match_jax,
)
from _torch_serve_mesh_jax import CASES

from repro_torch.launch.mesh import HostWorld


@pytest.fixture(scope="module")
def world():
    w = HostWorld(2)
    yield w
    w.close()


@pytest.mark.parametrize("name,dm", [("granite-20b", 2),
                                     ("granite-20b-kv2", 4)])
def test_kv_leaves_stay_whole_where_jax_drops_the_model_axis(name, dm):
    dims, _ = placement_matches_jax(*CASES[name](), dm)
    for layer in dims["segments"][0].values():
        assert layer["mixer"] == {"wq": 2, "wk": -1, "wv": -1, "wo": 1}


def test_mqa_round_matches_jax(world):
    round_and_vmap_match_jax(world, "granite-20b", *CASES["granite-20b"](),
                             (1, 2), 1e-5)
