"""The dry run's per-rank records (``launch.dryrun.per_rank``, every
record's ``per_rank``) and ``--multi-pod``, against the JAX package's
shardings, for every arch and shape on meta tensors.

A rank's bytes of params, optimizer state, inputs and caches equal the
bytes the JAX dry run's shardings put on a device, computed here with the
JAX package's own ``spec_tree`` over its ``param_axes`` / ``cache_axes``
and the in_shardings of its ``lower_train`` / ``lower_prefill`` /
``lower_decode`` (the batch on "client" and "replica", the clients'
sigmas on "client"; the prompt rows on "data"; decode's tokens on "data"
unless a long context takes no row split, the position replicated), on
the 16x16 mesh and on ``--multi-pod``'s 2x16x16 (8 clients, the (32, 16)
serving mesh), with the device memory at JAX's 16 GiB so that the
weights split over "data" where the JAX dry run splits them
(mistral-large-123b and llama4-maverick-400b-a17b). One departure: the
port's ``cache_axes`` keeps Mamba2's conv window whole (zamba2), which
JAX splits over "model"; the JAX side here takes the port's table for
that leaf.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import functools
import json
import math
import types

import jax
import numpy as np
import pytest

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_arch as jax_get_arch
from repro.configs import get_shape as jax_get_shape
from repro.configs import input_specs as jax_input_specs
from repro.configs import supports_shape
from repro.launch import dryrun as jax_dryrun
from repro.models import sharding as jshard
from repro.models.transformer import Transformer as JaxTransformer
from repro.optim import sgd as jax_sgd
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.configs.shapes import InputShape, get_shape
from repro_torch.launch import dryrun

GIB16 = jax_dryrun.HBM_PER_CHIP
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _nbytes(x) -> int:
    return math.prod(x.shape) * np.dtype(x.dtype).itemsize


def _split(n: int, spec, sizes) -> int:
    for axis in spec:
        for a in (() if axis is None else
                  (axis,) if isinstance(axis, str) else axis):
            n //= sizes[a]
    return n


def _spec_bytes(sizes, rules, axes, tree) -> int:
    with jshard.axis_rules(types.SimpleNamespace(shape=sizes), rules):
        specs = jshard.spec_tree(axes, tree)
    specs = jax.tree.leaves(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    return sum(_split(_nbytes(x), s, sizes)
               for s, x in zip(specs, jax.tree.leaves(tree)))


@functools.lru_cache(maxsize=None)
def _model(arch):
    model = JaxTransformer(jax_get_arch(arch))
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0))


def _port_conv_axes(axes):
    """JAX's cache axes with the port's one departure: Mamba2's conv
    window whole."""
    def walk(t):
        if isinstance(t, dict):
            return {k: ((None, "batch", None, None) if k == "conv" else
                        walk(v)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t
    return walk(axes)


def jax_per_rank(arch, shape_name, multi_pod, mem=GIB16) -> dict:
    """A device's bytes under the JAX dry run's shardings of ``arch`` at
    ``shape_name`` (``run_one``'s mesh, clients and rules)."""
    cfg, shape = jax_get_arch(arch), jax_get_shape(shape_name)
    model, params = _model(arch)
    axes = model.param_axes()
    n_ranks = 512 if multi_pod else 256
    if shape.kind == "train":
        c = 8 if multi_pod else 4
        fed = {"client": c, "replica": n_ranks // 16 // c, "model": 16}
        opt = jax.eval_shape(jax_sgd(0.1).init, params)
        batch = jax_input_specs(cfg, shape, n_clients=c, tau=4)
        inputs = sum(_split(_nbytes(x), ("client", None, "replica")
                            if x.shape[2] % fed["replica"] == 0
                            else ("client",), fed)
                     for x in jax.tree.leaves(batch)) + 4   # + sigmas
        return {"params": _spec_bytes(
                    fed, jshard.train_rules(),
                    jax_dryrun._prepend_client_axes(axes),
                    jax_dryrun._stack_clients(params, c)),
                "optimizer": sum(_nbytes(x) for x in jax.tree.leaves(opt)),
                "inputs": inputs, "caches": 0}
    serve = {"data": n_ranks // 16, "model": 16}
    fsdp = jax_dryrun.param_count(params) * 2 / 16 > 0.6 * mem
    rows = serve["data"]
    if shape.kind == "prefill":
        batch = jax_input_specs(cfg, shape)
        return {"params": _spec_bytes(serve, jshard.serve_rules(fsdp), axes,
                                      params),
                "optimizer": 0, "caches": 0,
                "inputs": sum(_nbytes(x) // rows
                              for x in jax.tree.leaves(batch))}
    b = shape.global_batch
    caches = jax.eval_shape(lambda: model.init_cache(b, shape.seq_len))
    shard_seq = shape.name == "long_500k"
    rules = jshard.serve_rules(fsdp_over_data=fsdp, shard_seq=shard_seq)
    kv_divides = cfg.n_kv_heads % 16 == 0          # lower_decode's overrides
    if shard_seq:
        rules["batch"] = None
        rules["cache_seq"] = ("data", "model") if not kv_divides else "data"
        rules["kv_tp"] = "model" if kv_divides else None
    elif not kv_divides:
        rules["kv_tp"] = None
        rules["cache_seq"] = "model"
    tokens = 4 * b // (rows if not shard_seq and b % rows == 0 else 1)
    return {"params": _spec_bytes(serve, rules, axes, params), "optimizer": 0,
            "inputs": tokens + 4,
            "caches": _spec_bytes(serve, rules,
                                  _port_conv_axes(model.cache_axes()),
                                  caches)}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_per_rank_bytes_equal_jax_shard_bytes(multi_pod):
    fsdp_archs = set()
    for arch in ASSIGNED_ARCHS:
        for name in SHAPES:
            if not supports_shape(jax_get_arch(arch),
                                  jax_get_shape(name))[0]:
                continue
            got = dryrun.per_rank(get_arch(arch), get_shape(name),
                                  multi_pod, device_mem_bytes=GIB16)
            want = jax_per_rank(arch, name, multi_pod)
            assert {k: got[f"{k}_bytes"] for k in want} == want, (arch, name)
            assert got["mesh"] == ("2x16x16" if multi_pod else "16x16")
            assert got["total_bytes"] == sum(want.values())
            if got.get("fsdp_over_data"):
                fsdp_archs.add(arch)
                assert got["rules"]["fsdp"] == got["rules"]["wg"] == "data"
            if name == "train_4k":
                assert got["n_clients"] == (8 if multi_pod else 4)
                assert got["mesh_axes"] == {"client": got["n_clients"],
                                            "replica": 4, "model": 16}
            else:
                assert got["mesh_axes"] == {
                    "data": 32 if multi_pod else 16, "model": 16}
    assert fsdp_archs == {"mistral-large-123b", "llama4-maverick-400b-a17b"}


def test_multi_pod_records_on_the_2x16x16_mesh(tmp_path):
    """``--multi-pod`` writes records tagged 2x16x16 whose ``per_rank`` is
    on the (32, 16) serving mesh with the rules the device memory decides
    (``--device-mem-gb 16``: mistral-large's weights over "data"); a smoke
    variant's train round is traced for 8 clients."""
    assert dryrun.main(["--arch", "mistral-large-123b", "--shape",
                        "decode_32k", "--multi-pod", "--device-mem-gb", "16",
                        "--out-dir", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "mistral-large-123b_decode_32k_1xH100"
                                  "_2x16x16.json").read_text())
    assert rec["status"] == "traced"
    assert rec["serving_rules"] == {
        "mesh_shape": [32, 16], "batch": "data", "seq": None,
        "kv_tp": None, "cache_seq": "model", "fsdp": "data", "wg": "data"}
    pr = rec["per_rank"]
    assert pr["fsdp_over_data"] and pr["device_mem_bytes"] == GIB16
    assert pr["params_bytes"] == jax_per_rank("mistral-large-123b",
                                              "decode_32k", True)["params"]
    # the card's memory (the default) keeps mistral-large's weights whole
    # over "data" on 16 model ranks
    card = dryrun.serving_rules(get_arch("mistral-large-123b"),
                                get_shape("decode_32k"), multi_pod=True)
    assert card["fsdp"] is None and card["wg"] is None
    cfg = smoke_variant(get_arch("gemma3-4b"))
    train = dryrun.run_one("gemma3-4b", "mini", cfg=cfg, multi_pod=True,
                           tau=1, shape=InputShape("mini", 16, 8, "train"))
    assert train["n_clients"] == 8 and train["per_rank"]["n_clients"] == 8
    pr = train["per_rank"]
    assert pr["mesh"] == "2x16x16" and pr["rules"]["fsdp"] == "replica"
    assert pr["total_bytes"] == sum(pr[f"{k}_bytes"] for k in (
        "params", "optimizer", "inputs", "caches")) > 0
