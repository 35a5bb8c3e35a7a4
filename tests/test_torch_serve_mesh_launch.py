"""The serving mesh's placement tables, its launcher and its refusals.

* ``Transformer.cache_axes`` is the JAX package's table but for Mamba2's
  conv window, which stays whole (every rank convolves every channel);
  ``cache_split_dims`` puts the KV caches', RWKV6's ``wkv`` and Mamba2's
  ``h`` split on their heads.
* The serving placement is the training mesh's: ``param_split_dims``
  under ``serve_mesh_rules`` equals it under ``mesh2d_rules`` for every
  served arch, where the JAX package's literal ``serve_rules`` would split
  Mamba2's ``w_in`` and RWKV6's projections on their columns.
* ``python -m repro_torch.launch.serve ... --env-profile cpu-mesh
  --host-devices 2`` (two gloo ranks on the serving mesh (1, 2)) prints
  the one-rank run's tokens, in the engine mode and with ``--static``.
* A model axis that does not divide the heads raises ``ValueError``
  naming the ones that do. KV heads the model axis does not divide
  (granite-20b's MQA) are served (tests/test_torch_serve_mesh_mqa*.py).
  Weights over the data axis (``serve_rules(fsdp_over_data=True)``) and
  the dry run's ``--multi-pod``, once refused naming ROADMAP item 12d,
  run: the serving route's hints resolve under those rules, the data
  split takes the dims the JAX package names, and ``--multi-pod`` gives
  per-rank records on the 2x16x16 mesh (served in
  tests/test_torch_serve_mesh_fsdp*.py, recorded in
  tests/test_torch_dryrun_per_rank.py).
* The launcher's engine mode on two ranks agrees on one clock: its
  ranks' schedules no longer follow each rank's own wall clock
  (tests/test_torch_serve_clock.py).
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import contextlib
import io
import json
from types import SimpleNamespace

import jax
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke_variant
from repro.models.transformer import Transformer as JaxTransformer
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.configs.shapes import get_shape
from repro_torch.launch import dryrun, serve
from repro_torch.models import sharding
from repro_torch.models.transformer import Transformer

SERVED = ["gemma3-4b", "rwkv6-1.6b", "zamba2-7b", "phi3.5-moe-42b-a6.6b",
          "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("arch", SERVED)
def test_cache_axes_are_jax_but_the_conv_window(arch):
    want = JaxTransformer(jax_smoke_variant(jax_get_arch(arch))).cache_axes()
    model = Transformer(smoke_variant(get_arch(arch)))
    got = model.cache_axes()
    for j, (seg_w, seg_g) in enumerate(zip(want, got)):
        for k, layer in seg_w.items():
            if "conv" in layer.get("mixer", {}):
                assert layer["mixer"].pop("conv") == (None, "batch", None,
                                                      "tp")
                assert seg_g[k]["mixer"].pop("conv") == (None, "batch", None,
                                                         None)
    assert got == want
    with sharding.axis_rules(SimpleNamespace(shape={"data": 1, "model": 2}),
                             sharding.serve_mesh_rules()):
        dims = jax.tree.leaves(sharding.cache_split_dims(model.cache_axes()))
    want_dims = []
    for seg in model.cfg.segments:
        for ls in seg.pattern:       # leaves in sorted key order
            want_dims += [-1] if ls.ffn == "rwkv_cm" else []
            want_dims += {"attn": [3, 3], "shared_attn": [3, 3],
                          "rwkv6": [-1, 2], "mamba2": [-1, 2]}[ls.mixer]
    assert dims == want_dims
    for shape in ({"data": 2, "model": 1}, None):
        ctx = (contextlib.nullcontext() if shape is None else
               sharding.axis_rules(SimpleNamespace(shape=shape),
                                   sharding.serve_mesh_rules()))
        with ctx:
            assert set(jax.tree.leaves(sharding.cache_split_dims(
                model.cache_axes()))) == {-1}


@pytest.mark.parametrize("arch", SERVED)
def test_serving_placement_is_the_training_mesh_placement(arch):
    model = Transformer(get_arch(arch))
    one = model.init(device="meta")
    serving = sharding.param_split_dims(one, 2, sharding.serve_mesh_rules())
    assert serving == sharding.param_split_dims(one, 2)
    literal = sharding.param_split_dims(one, 2, sharding.serve_rules())
    mixer = literal["segments"][-1]["0"]["mixer"]
    if "w_in" in mixer:            # Mamba2: z, x, B, C, dt side by side
        assert mixer["w_in"] == 2
    if "w_r" in mixer:
        assert mixer["w_r"] == 2


class _RankZero:
    """A (data 2, model 2) mesh as rank 0 sees it, without a process
    group: enough for the model code to reach its first hint."""
    mesh_dim_names, shape = ("data", "model"), (2, 2)

    @staticmethod
    def get_coordinate():
        return [0, 0]

    @staticmethod
    def get_group(axis):
        return None


def test_check_model_axis_refusals():
    gemma = Transformer(smoke_variant(get_arch("gemma3-4b")))
    gemma.check_model_axis(1)
    gemma.check_model_axis(4)
    with pytest.raises(ValueError, match=r"can be one of \[1, 2, 4\]"):
        gemma.check_model_axis(3)
    granite = Transformer(smoke_variant(get_arch("granite-20b")))
    granite.check_model_axis(2)         # MQA: its K/V stay whole
    with pytest.raises(ValueError, match=r"can be one of \[1, 2, 4\]"):
        granite.check_model_axis(8)
    # weights over "data": the serving route's hints resolve to the split
    # each layer body runs on, and the data split takes JAX's dims
    params = gemma.init(device="meta")
    layer = params["segments"][0]["0"]
    with sharding.axis_rules(_RankZero(), sharding.serve_rules(
            fsdp_over_data=True)):
        for name, sub, axes in (
                ("attention", layer["mixer"], sharding.ATTN_AXES),
                ("the MLP", layer["ffn"], sharding.MLP_AXES)):
            dims = {k: sharding.model_dim(*axes[k]) for k in sub}
            assert dims == {k: 0 if k in ("wo", "w_down") else 1
                            for k in sub}, name
            assert sharding.hinted_group(name, {k: v[0] for k, v in
                                                sub.items()}, axes) \
                is not sharding.WHOLE
    data = sharding.data_split_dims(params, (2, 2))
    assert data["embed"] == {"embedding": 1}
    assert data["segments"][0]["0"]["mixer"] == {"wq": 1, "wk": 1, "wv": 1,
                                                 "wo": 3}
    assert data["segments"][0]["0"]["ffn"] == {"w_gate": 1, "w_up": 1,
                                               "w_down": 2}
    rec = dryrun.per_rank(gemma.cfg, get_shape("train_4k"), multi_pod=True)
    assert rec["mesh"] == "2x16x16" and rec["n_clients"] == 8


def _launch(argv):
    """``python -m repro_torch.launch.serve argv`` in a fresh process (one
    torch thread): its printed JSON and its whole stdout."""
    import os
    import subprocess
    import sys

    from _torch_threads import SUBPROCESS_ENV
    env = {**os.environ, **SUBPROCESS_ENV,
           "PYTHONPATH": os.pathsep.join(p for p in sys.path if p)}
    env.pop("REPRO_ENV_PROFILE_APPLIED", None)
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"]
                         + argv, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout[out.stdout.index("{"):
                                 out.stdout.rindex("}") + 1]), out.stdout


def _one_rank(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert serve.main(argv) == 0
    out = buf.getvalue()
    return json.loads(out[out.index("{"):out.rindex("}") + 1])


@pytest.mark.parametrize("mode", [[], ["--static"]])
def test_launcher_on_two_ranks_prints_the_one_rank_tokens(mode):
    argv = ["--arch", "gemma3-4b", "--smoke", "--device", "cpu", "--batch",
            "2", "--requests", "3", "--prompt-len", "8", "--gen", "4",
            "--block-size", "4"] + mode
    want = _one_rank(argv)
    got, stdout = _launch(argv + ["--env-profile", "cpu-mesh",
                                  "--host-devices", "2"])
    assert "[env] profile cpu-mesh applied" in stdout
    assert stdout.count('"sample"') == 1             # rank 0 prints alone
    assert got["mesh_shape"] == [1, 2]
    assert got["mode"] == want["mode"]
    assert got["sample"] == want["sample"] and len(got["sample"]) == 4
