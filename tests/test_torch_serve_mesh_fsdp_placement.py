"""Where the serving mesh puts each weight when it splits the weights over
"data" too, against the JAX package, for every arch at its published
widths on meta tensors (no tensor allocated).

* ``models.sharding.param_split_dims`` (the model axis) and
  ``data_split_dims`` (the data axis) give each leaf's (dim, mesh axis)
  pairs; the JAX package's ``spec_tree(param_axes, params)`` under
  ``serve_rules(fsdp_over_data=True)`` gives its own, on a stand-in mesh
  of (2, 2), (4, 1), (16, 16) and (32, 16) ranks (axes of one rank split
  nothing). They are equal but for the leaves of :data:`DEPARTURES`,
  each with its reason, where the port's model split takes the dim JAX
  gives "data"; there the port's model split is the training mesh's (the
  first dim the leaf's hint names), and its data split the other dim its
  hint names, if any. An arch whose split dims a model axis does not
  divide is refused by ``Transformer.check_model_axis`` (gemma3-4b and
  llama4-maverick at 16: 8 query heads), where JAX drops the axis.
* ``models.sharding.needs_param_sharding`` at JAX's 16 GiB decides as
  the JAX dry run's ``_needs_param_sharding`` on the (16, 16) serving
  mesh for every arch (true for mistral-large-123b and
  llama4-maverick-400b-a17b).
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import functools
import types

import jax
import pytest

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_arch as jax_get_arch
from repro.launch import dryrun as jax_dryrun
from repro.models import sharding as jshard
from repro.models.transformer import Transformer as JaxTransformer
from repro_torch.configs import get_arch
from repro_torch.mesh.placement import H100_MEM_BYTES
from repro_torch.models import sharding
from repro_torch.models.transformer import Transformer
from repro_torch.utils.tree import tree_flatten, tree_leaf_paths

# leaf (its parent's key / its key) -> why the port places it otherwise
_SWAP = ("the port splits it over 'model' on its rows, as the training "
         "mesh does, so each layer keeps one split body; the data split "
         "takes its columns, where JAX puts 'model'")
_ONE = ("its hint names one dim, which the port's model split takes as "
        "the training mesh does: it stays whole over 'data' (JAX splits it "
        "over 'data' there and keeps it whole over 'model')")
DEPARTURES = {
    "mixer/w_in": _SWAP + " (Mamba2: z, x, B, C and dt side by side do "
                          "not line up with the heads)",
    "mixer/w_r": _SWAP + " (RWKV6's time-mix projections)",
    "mixer/w_k": _SWAP, "mixer/w_v": _SWAP, "mixer/w_g": _SWAP,
    "ffn/w_k": _SWAP + " (RWKV6's channel mix)", "ffn/w_r": _SWAP,
    "mixer/decay_a": _ONE + " (RWKV6's decay LoRA)",
    "mixer/lora_q_a": _ONE + " (zamba2's shared-attention LoRA)",
    "mixer/lora_o_b": _ONE,
}
MESHES = [(2, 2), (4, 1), (16, 16), (32, 16)]


@functools.lru_cache(maxsize=None)
def _jax(arch):
    model = JaxTransformer(jax_get_arch(arch))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return shapes, model.param_axes()


def _leaf(path: str) -> str:
    return "/".join(path.split("/")[-2:])


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_fsdp_placement_matches_jax_spec_tree(mesh_shape):
    dd, dm = mesh_shape
    sizes = {"data": dd, "model": dm}
    refused = []
    for arch in ASSIGNED_ARCHS:
        model = Transformer(get_arch(arch))
        try:
            model.check_model_axis(dm)
        except ValueError:
            refused.append(arch)
            continue
        params = model.init(device="meta")
        model_dims = tree_flatten(sharding.param_split_dims(
            params, dm, sharding.serve_mesh_rules()))[0]
        data_dims = tree_flatten(sharding.data_split_dims(params,
                                                          mesh_shape))[0]
        shapes, axes = _jax(arch)
        with jshard.axis_rules(types.SimpleNamespace(shape=sizes),
                               jshard.serve_rules(fsdp_over_data=True)):
            specs = jax.tree.leaves(
                jshard.spec_tree(axes, shapes),
                is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        logical = jax.tree.leaves(sharding.param_logical_axes(params),
                                  is_leaf=lambda x: isinstance(x, tuple))
        paths = tree_leaf_paths(params)
        assert len(specs) == len(paths) == len(model_dims) == len(logical)
        departed = set()
        for path, m, d, spec, lg in zip(paths, model_dims, data_dims, specs,
                                        logical):
            port = {(i, a) for i, a in ((m, "model"), (d, "data"))
                    if i >= 0 and sizes[a] > 1}
            want = {(i, a) for i, a in enumerate(spec)
                    if a is not None and sizes[a] > 1}
            if port == want:
                continue
            departed.add(_leaf(path))
            assert _leaf(path) in DEPARTURES, (arch, mesh_shape, path, port,
                                               want)
            # the port's model split is the training mesh's: the first dim
            # the hint names "fsdp" or "tp"
            assert m == next(i for i, a in enumerate(lg)
                             if a in ("fsdp", "tp")), (arch, path)
            assert d != m
        want_departed = {
            "rwkv6-1.6b": {k for k in DEPARTURES if k.split("/")[1] in (
                "w_r", "w_k", "w_v", "w_g", "decay_a")},
            "zamba2-7b": {"mixer/w_in", "mixer/lora_q_a", "mixer/lora_o_b"},
        }.get(arch, set()) if dm > 1 else set()
        assert departed == want_departed, (arch, mesh_shape, departed)
    assert refused == ([] if dm < 16 else
                       ["gemma3-4b", "llama4-maverick-400b-a17b"])


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_needs_param_sharding_matches_jax(arch):
    shapes, _ = _jax(arch)
    n = sum(x.numel() for x in tree_flatten(
        Transformer(get_arch(arch)).init(device="meta"))[0])
    assert n == jax_dryrun.param_count(shapes)
    want = jax_dryrun._needs_param_sharding(
        shapes, types.SimpleNamespace(shape={"data": 16, "model": 16}))
    assert sharding.needs_param_sharding(
        n, 16, jax_dryrun.HBM_PER_CHIP) == want
    assert want == (arch in ("mistral-large-123b",
                             "llama4-maverick-400b-a17b"))
    # on the card (79.18 GiB) mistral-large at its 88 layers needs it at
    # a model axis of 2 and 4, the widths phase 24 serves on (2, 2)
    if arch == "mistral-large-123b":
        assert all(sharding.needs_param_sharding(n, dm, H100_MEM_BYTES)
                   for dm in (1, 2, 4))
