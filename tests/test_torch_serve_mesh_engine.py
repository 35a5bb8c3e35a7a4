"""The serving mesh's paged route, its continuous-batching engine and its
data axis, in one gloo world of 4 ranks started once for the module, on
the CPU at smoke widths in f32 with JAX's own weights
(tests/_torch_serve_mesh_jax.py):

* the paged route at (1, 2) (``prefill_at`` of right-padded prompts,
  ``insert_prefill`` through a shuffled block table, 8 teacher-forced
  ``decode_step(table=)`` steps): logits and the pools made whole along
  their heads within 2e-5 of the whole route's;
* a ``serve_continuous`` workload through ``SlotEngine`` at (1, 2): every
  request's tokens and every block table equal the whole engine's, the
  tables alike on both ranks;
* ``generate`` at (2, 1) and (2, 2): each data row of ranks takes its
  half of the rows, and the gathered tokens equal the whole route's (the
  logits within 2e-5), alike on every rank; sampled decode draws the same
  tokens on both ranks of a (1, 2) mesh;
* ``load_federated_params`` on the mesh (1, 2) loads the whole JAX
  checkpoint and keeps each rank's slices: joined again they are the
  whole load bit for bit, and each rank's are ``to_local``'s;
* the ``ValueError`` s: a batch the data axis does not split, and the
  engine on a data axis over 1.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import _torch_world_cases as cases
import numpy as np
import pytest
from _torch_serve_mesh_jax import (
    close,
    close_caches,
    generate_whole,
    models,
    prompts,
)
from test_torch_serve import _write_jax_checkpoint

from repro_torch.configs import get_arch, smoke_variant
from repro_torch.launch import serve
from repro_torch.launch.mesh import HostWorld
from repro_torch.models import sharding
from repro_torch.models.transformer import Transformer
from repro_torch.utils.convert import tree_to_numpy
from repro_torch.utils.tree import tree_flatten


@pytest.fixture(scope="module")
def world():
    w = HostWorld(4)
    yield w
    w.close()


def _inside(got, n):
    got = [g for g in got if g is not None]
    assert len(got) == n
    return got


@pytest.mark.parametrize("name", ["gemma3-4b", "llama4-maverick-400b-a17b",
                                  "zamba2-7b"])
def test_paged_route_on_the_serving_mesh_matches_the_whole_route(world,
                                                                 name):
    _, _, model, params = models(name)
    pr = prompts(model.cfg.vocab, seed=2)[:, :16]
    # right padding for the attention archs; exact lengths for zamba2,
    # whose recurrent state would consume pad tokens (pad_ok)
    lengths = np.array([16, 16 if name == "zamba2-7b" else 11])
    forced = np.random.default_rng(3).integers(0, model.cfg.vocab, (2, 8))
    p_np = tree_to_numpy(params)
    got = _inside(world.run(cases.serve_mesh_paged, model.cfg, p_np, pr,
                            lengths, forced, 4, (1, 2)), 2)
    want = cases.paged_route_whole(model.cfg, p_np, pr, lengths, forced, 4)
    for key in ("prefill_logits", "decode_logits"):
        assert np.array_equal(got[0][key], got[1][key]), key
        close(got[0][key], want[key], f"{name} {key}")
    for key in ("inserted", "decoded"):
        close_caches(got[0][key], want[key], f"{name} {key} pools")


# zamba2's prompts are whole SSD chunks (8): its prefill is exact-length
@pytest.mark.parametrize("name,prompt_lens", [("gemma3-4b", (5, 8, 12)),
                                              ("zamba2-7b", (8, 16))])
def test_engine_on_the_serving_mesh_equals_the_whole_engine(world, name,
                                                            prompt_lens):
    _, _, model, params = models(name)
    args = (model.cfg, tree_to_numpy(params), 6, prompt_lens, (4, 9), 3, 4)
    got = _inside(world.run(cases.serve_mesh_engine, *args, (1, 2)), 2)
    want = cases.serve_mesh_engine(*args)
    assert len(want["tokens"]) == 6
    for r in got:
        assert r["tokens"] == want["tokens"]
        assert np.array_equal(r["tables"], want["tables"])


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)])
def test_generate_splits_rows_over_the_data_axis(world, mesh_shape):
    _, _, model, params = models("gemma3-4b")
    want_tokens, want_logits = generate_whole("gemma3-4b", 4, seed=4)
    got = _inside(world.run(
        cases.serve_mesh_generate, model.cfg, tree_to_numpy(params),
        prompts(model.cfg.vocab, 4, seed=4), 8, mesh_shape),
        mesh_shape[0] * mesh_shape[1])
    for r in got:
        assert np.array_equal(r["tokens"], got[0]["tokens"])
        assert np.array_equal(r["logits"], got[0]["logits"])
    np.testing.assert_array_equal(got[0]["tokens"], want_tokens)
    close(got[0]["logits"], want_logits, f"{mesh_shape} logits")


def test_sampled_decode_draws_alike_on_the_model_axis(world):
    _, _, model, params = models("rwkv6-1.6b")
    got = _inside(world.run(
        cases.serve_mesh_generate, model.cfg, tree_to_numpy(params),
        prompts(model.cfg.vocab, 2, seed=5), 8, (1, 2), 1.0), 2)
    assert np.array_equal(got[0]["tokens"], got[1]["tokens"])
    assert np.array_equal(got[0]["logits"], got[1]["logits"])


def test_rows_and_engine_refusals_on_a_data_axis(world):
    _, _, model, params = models("gemma3-4b")
    for r in world.run(cases.serve_mesh_refusals, model.cfg,
                       tree_to_numpy(params)):
        kind, msg = r["rows"]
        assert kind == "ValueError" and "does not split over a data axis " \
            "of 2" in msg
        kind, msg = r["engine"]
        assert kind == "ValueError" and "data axis is 1" in msg


def test_federated_checkpoint_loads_the_ranks_slices(world, tmp_path):
    _write_jax_checkpoint(tmp_path, "full_average")
    gemma = Transformer(smoke_variant(get_arch("gemma3-4b")))
    whole = serve.load_federated_params(gemma, str(tmp_path), "cpu")
    dims = sharding.param_split_dims(whole, 2)
    got = _inside(world.run(cases.serve_mesh_checkpoint, "gemma3-4b",
                            str(tmp_path), (1, 2)), 2)
    for index, r in enumerate(got):
        want_local = sharding.to_local(whole, dims, index, 2)
        for a, b in zip(tree_flatten(r["local"])[0],
                        tree_flatten(want_local)[0]):
            assert np.array_equal(a, b.numpy())
        for a, b in zip(tree_flatten(r["whole"])[0],
                        tree_flatten(whole)[0]):
            assert np.array_equal(a, b.numpy())
