"""A long context's decode cache split over the data axis (``shard_seq``,
the JAX dry run's ``long_500k`` rules) on the serving mesh, in one gloo
world of 4 ranks, against the JAX package's whole ``prefill`` /
``decode_step`` / ``generate`` and the port's whole route, on the CPU at
smoke widths in f32 with JAX's own weights
(tests/_torch_serve_mesh_jax.py).

* gemma3-4b's smoke widths (4 q / 2 kv heads, a sliding-window and a full
  layer) on (2, 1): every rank runs the whole batch and model, and holds
  half of every cache's slots (the data axis splits no rows).
* its MQA variant (one KV head) on (2, 2): the KV heads do not divide the
  model axis, so the cache's sequence splits over ("data", "model"), a
  quarter a rank, and the query heads are gathered over the model axis;
* gemma3-4b itself on (2, 2): its two KV heads divide the model axis, so
  each cache splits on both its sequence (over "data") and its heads
  (over "model"), a quarter a rank, combined over the data group alone.

Each is held as tests/test_torch_serve_mesh.py holds the model axis.
Refused with ``NotImplementedError``: the engine under ``shard_seq``. A
cache split on both its sequence and its heads, once refused naming item
12d, gets both dims.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import _torch_world_cases as cases
import pytest
from _torch_serve_mesh_jax import models, route_matches

from repro_torch.launch.mesh import HostWorld
from repro_torch.utils.convert import tree_to_numpy


@pytest.fixture(scope="module")
def world():
    w = HostWorld(4)
    yield w
    w.close()


@pytest.mark.parametrize("name,mesh_shape", [("gemma3-4b", (2, 1)),
                                             ("gemma3-4b-kv1", (2, 2)),
                                             ("gemma3-4b", (2, 2))])
def test_shard_seq_decode_matches_jax(world, name, mesh_shape):
    r0 = route_matches(world, name, mesh_shape, shard_seq=True)
    cfg = models(name)[2].cfg
    whole = 2 * 2 * (cfg.window + 40) * cfg.n_kv_heads * \
        cfg.resolved_head_dim * 4
    assert r0["cache_bytes"] * mesh_shape[0] * mesh_shape[1] == whole


def test_shard_seq_refusals(world):
    _, _, model, params = models("gemma3-4b")
    for r in world.run(cases.serve_mesh_shard_seq_refusals, model.cfg,
                       tree_to_numpy(params)):
        kind, msg = r["engine"]
        assert "static decode path" in msg
        # a KV cache (batch, seq, kv heads, hd) with a leading step axis:
        # the sequence over "data", the heads over "model"
        assert r["both"] == [(2, 3), (2, 3)]
