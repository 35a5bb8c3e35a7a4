"""The serving route on the serving mesh (``launch.serve.serve_on_mesh``):
the attention archs, split over a model axis of two gloo ranks (the mesh
(1, 2)), against the JAX package's ``prefill`` / ``decode_step`` and the
port's whole route, on the CPU at smoke widths in f32 with JAX's own
weights (tests/_torch_serve_mesh_jax.py).

* gemma3-4b's smoke widths with GQA (4 q / 2 kv heads: one kv head and two
  q heads a rank), cut to a sliding-window and a full layer, with the tied
  embedding (vocabulary slices gathered into the logits) and with an
  untied head (split on its d_model rows, into an all-reduce);
* llama4-maverick's smoke variant: chunked attention, a full layer, the
  MoE with its shared expert (two experts a rank) and the dense MLP.

Each is held, within 2e-5 of each tensor's largest magnitude, on its
prefill logits, every cache leaf made whole along its ``cache_axes`` dim
(the KV caches' heads) and 8 teacher-forced decode steps' logits and
caches; its greedy tokens are JAX's; the two ranks' logits and tokens are
bit for bit alike; a decode step makes the collectives the code predicts.
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


@pytest.mark.parametrize("name", ["gemma3-4b", "gemma3-4b-untied",
                                  "llama4-maverick-400b-a17b"])
def test_attention_archs_on_the_serving_mesh_match_jax(world, name):
    route_matches(world, name)
