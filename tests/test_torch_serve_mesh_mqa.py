"""KV heads the model axis does not divide, on the serving mesh
(``launch.serve.serve_on_mesh``): K/V whole on every model rank, the
decode cache's sequence split over the model axis (``cache_seq``), in one
gloo world of 4 ranks, against the JAX package's ``prefill`` /
``decode_step`` / ``generate`` and the port's whole route, on the CPU at
smoke widths in f32 with JAX's own weights
(tests/_torch_serve_mesh_jax.py).

* granite-20b's smoke widths (4 q heads, MQA: one KV head), a
  sliding-window layer (window 16) and a full one, on (1, 2): each rank
  holds a contiguous half of every cache's slots. 32-token prompts wrap
  the ring; 4-token prompts leave the second rank's block of both caches
  without a visible slot for the first decode steps.
* a 2-KV-head variant on (1, 4): each rank's one query head reads KV head
  ``index // 2``, the head offset a rank's local grouping would get wrong;
  its window of 6 is not divided by the four ranks, so that ring stays
  whole on every rank while the full cache splits in quarters.

Each is held, within 2e-5 of each tensor's largest magnitude, on its
prefill logits, every cache leaf made whole over its group and 8
teacher-forced decode steps' logits and caches; its greedy tokens are
JAX's; the ranks' logits and tokens are bit for bit alike; a decode step
makes the collectives the code predicts; a rank's cache holds its block.
The engine's paged pools stay whole on every rank: its route and its
``serve_continuous`` run equal the whole engine's.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import _torch_world_cases as cases
import numpy as np
import pytest
from _torch_serve_mesh_jax import (
    GEN,
    close,
    close_caches,
    models,
    prompts,
    route_matches,
)

from repro_torch.launch.mesh import HostWorld
from repro_torch.utils.convert import tree_to_numpy


@pytest.fixture(scope="module")
def world():
    w = HostWorld(4)
    yield w
    w.close()


def _kv_bytes(cfg, b, max_len, g):
    """One rank's KV cache bytes (f32): a ring the g ranks do not divide
    whole, every other cache a 1 / g block of its (rounded) slots."""
    n_full = -(-max_len // g) * g
    slots = 0
    for seg in cfg.segments:
        for ls in seg.pattern:
            n = min(cfg.window, n_full) if ls.attn_kind == "swa" else n_full
            slots += n // g if n % g == 0 else n
    return 2 * b * slots * cfg.n_kv_heads * cfg.resolved_head_dim * 4


@pytest.mark.parametrize("name,mesh_shape,s", [
    ("granite-20b", (1, 2), 32), ("granite-20b", (1, 2), 4),
    ("granite-20b-kv2", (1, 4), 32), ("granite-20b-kv2", (1, 4), 4)])
def test_whole_kv_serving_matches_jax(world, name, mesh_shape, s):
    r0 = route_matches(world, name, mesh_shape, s=s)
    cfg = models(name)[2].cfg
    assert r0["cache_bytes"] == _kv_bytes(cfg, 2, s + GEN, mesh_shape[1])
    assert r0["cache_bytes"] < _kv_bytes(cfg, 2, s + GEN, 1)


@pytest.mark.parametrize("name,mesh_shape", [("granite-20b", (1, 2)),
                                             ("granite-20b-kv2", (1, 4))])
def test_whole_kv_paged_route_and_engine_match_the_whole_engine(
        world, name, mesh_shape):
    _, _, model, params = models(name)
    p_np = tree_to_numpy(params)
    n = mesh_shape[1]
    pr = prompts(model.cfg.vocab, seed=2)[:, :16]
    lengths = np.array([16, 11])
    forced = np.random.default_rng(3).integers(0, model.cfg.vocab, (2, 8))
    got = [g for g in world.run(cases.serve_mesh_paged, model.cfg, p_np, pr,
                                lengths, forced, 4, mesh_shape)
           if g is not None]
    assert len(got) == n
    want = cases.paged_route_whole(model.cfg, p_np, pr, lengths, forced, 4)
    for key in ("prefill_logits", "decode_logits"):
        for r in got[1:]:
            assert np.array_equal(r[key], got[0][key]), key
        close(got[0][key], want[key], f"{name} {key}")
    for key in ("inserted", "decoded"):        # the pools, whole on a rank
        close_caches(got[0][key], want[key], f"{name} {key} pools")
    args = (model.cfg, p_np, 6, (5, 8, 12), (4, 9), 3, 4)
    got = [g for g in world.run(cases.serve_mesh_engine, *args, mesh_shape)
           if g is not None]
    assert len(got) == n
    want = cases.serve_mesh_engine(*args)
    for r in got:
        assert r["tokens"] == want["tokens"]
        assert np.array_equal(r["tables"], want["tables"])
