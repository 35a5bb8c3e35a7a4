"""Weights split over the serving mesh's data axis too
(``serve_on_mesh(..., fsdp_over_data=True)``, the JAX package's
``serve_rules(fsdp_over_data=True)``), in one gloo world of 4 ranks on the
mesh (2, 2), on the CPU at smoke widths in f32 with JAX's own weights
(tests/_torch_serve_mesh_jax.py): gemma3-4b (GQA, a sliding-window and a
full layer, tied embedding), phi3.5-moe (experts over "model", each
expert's width over "data"), rwkv6 and zamba2 (Mamba2 and the shared
attention block with its LoRA).

Each rank keeps a block of its model slice along the second dim of
``models.sharding.data_split_dims`` and the serving route gathers a
layer's blocks over the data group before the layer. Each is held as
tests/test_torch_serve_mesh.py holds the model axis: prefill logits, every
cache leaf, 8 teacher-forced decode steps within 2e-5 of the largest
magnitude of JAX's and of the whole route's; greedy tokens JAX's; the
ranks alike; a decode step's collectives as the code predicts (one data
gather a layer, one for the embedding and one for the head, beside the
model axis' collectives). A rank's param bytes are the whole's cut by
both placements: each leaf over ``dm`` where the model axis splits it and
over ``dd`` where the data axis does. The data axis of 4 (the mesh
(4, 1)) is tests/test_torch_serve_mesh_fsdp_data4.py.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest
from _torch_serve_mesh_jax import models, route_matches

from repro_torch.models import sharding
from repro_torch.utils.tree import tree_flatten

FAMILIES = ["gemma3-4b", "phi3.5-moe-42b-a6.6b", "rwkv6-1.6b", "zamba2-7b"]


def predicted_param_bytes(name, mesh_shape) -> int:
    """A rank's bytes of ``name``'s params on ``mesh_shape`` under
    fsdp_over_data: each leaf's whole bytes over ``dm`` where
    ``param_split_dims`` splits it and over ``dd`` where
    ``data_split_dims`` does."""
    dd, dm = mesh_shape
    params = models(name)[3]
    model = tree_flatten(sharding.param_split_dims(
        params, dm, sharding.serve_mesh_rules()))[0]
    data = tree_flatten(sharding.data_split_dims(params, mesh_shape))[0]
    total = 0
    for x, m, d in zip(tree_flatten(params)[0], model, data):
        assert m < 0 or d != m, (name, x.shape, m, d)
        total += (x.numel() * x.element_size() // (dm if m >= 0 else 1)
                  // (dd if d >= 0 else 1))
    return total


def fsdp_route(world, name, mesh_shape, batch):
    r0 = route_matches(world, name, mesh_shape, fsdp=True, batch=batch)
    want = predicted_param_bytes(name, mesh_shape)
    assert r0["param_bytes"] == want, (name, r0["param_bytes"], want)
    whole = sum(x.numel() * x.element_size()
                for x in tree_flatten(models(name)[3])[0])
    assert r0["param_bytes"] < whole / mesh_shape[1]


@pytest.fixture(scope="module")
def world():
    from repro_torch.launch.mesh import HostWorld
    w = HostWorld(4)
    yield w
    w.close()


@pytest.mark.parametrize("name", FAMILIES)
def test_weights_over_data_on_2x2_match_jax(world, name):
    fsdp_route(world, name, (2, 2), batch=2)
