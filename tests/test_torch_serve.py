"""The port's static serving path (``repro_torch.launch.serve``) against the
JAX package's (``repro.launch.serve``), on the CPU at ``smoke_variant``
size in f32, with JAX's own weights carried across.

Greedy tokens are compared only where they are well defined: at every step
the top-two gap of JAX's logits must exceed LOGIT_TOL, the largest logit
gap the model tests allow between the packages (2e-5 of logits of
magnitude <= ~5, tests/test_torch_models.py), so an argmax cannot flip
between them.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke_variant
from repro.launch.serve import generate as jax_generate
from repro.launch.serve import (
    load_federated_params as jax_load_federated_params,
)
from repro.models.transformer import Transformer as JaxTransformer

from repro_torch.configs import get_arch, smoke_variant
from repro_torch.launch import serve
from repro_torch.models.transformer import Transformer
from repro_torch.utils.convert import transformer_params_from_jax
from repro_torch.utils.tree import tree_flatten

LOGIT_TOL = 1e-4
PROMPT, GEN = 32, 8
SERVE_ARCHS = ["gemma3-4b", "rwkv6-1.6b", "zamba2-7b", "phi3.5-moe-42b-a6.6b",
               "llama4-maverick-400b-a17b"]


@functools.lru_cache(maxsize=None)
def _models(arch):
    jm = JaxTransformer(jax_smoke_variant(jax_get_arch(arch)))
    jp = jm.init(jax.random.PRNGKey(0))
    model = Transformer(smoke_variant(get_arch(arch)))
    params = transformer_params_from_jax(jax.tree.map(np.asarray, jp), model,
                                         "cpu")
    return jm, jp, model, params


def _prompts(vocab, seed=0, batch=2):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(batch, PROMPT)).astype(np.int32)


def _jax_step_logits(jm, jp, prompts, tokens):
    """JAX's logits before each generated token, teacher-forced with
    ``tokens`` (B, GEN)."""
    logits, caches, pos = jm.prefill(jp, jnp.asarray(prompts),
                                     max_len=PROMPT + GEN)
    out = [np.asarray(logits)]
    step = jax.jit(jm.decode_step)
    for i in range(tokens.shape[1] - 1):
        logits, caches = step(jp, caches, jnp.asarray(tokens[:, i]),
                              pos + i)
        out.append(np.asarray(logits))
    return out


def _top2_gap(logits):
    top = np.sort(logits, axis=-1)[:, -2:]
    return float(np.min(top[:, 1] - top[:, 0]))


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_greedy_generate_gives_jax_tokens(arch):
    jm, jp, model, params = _models(arch)
    prompts = _prompts(model.cfg.vocab)
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompts), GEN))
    for i, logits in enumerate(_jax_step_logits(jm, jp, prompts, want)):
        assert _top2_gap(logits) > LOGIT_TOL, (arch, i)
    got = serve.generate(model, params, torch.as_tensor(prompts), GEN)
    assert got.shape == (2, GEN)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_is_deterministic_per_generator_seed():
    _, _, model, params = _models("rwkv6-1.6b")
    prompts = torch.as_tensor(_prompts(model.cfg.vocab, seed=1))

    def run(seed):
        return serve.generate(model, params, prompts, GEN, temperature=1.0,
                              generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.dtype == torch.int64 and a.shape == (2, GEN)
    assert int(a.min()) >= 0 and int(a.max()) < model.cfg.vocab


def test_generate_runs_under_inference_mode():
    _, _, model, params = _models("gemma3-4b")
    out = serve.generate(model, params,
                         torch.as_tensor(_prompts(model.cfg.vocab)), 2)
    assert out.is_inference()


def _write_jax_checkpoint(directory, topology):
    """A 2-client smoke FLState of the JAX package, the clients' params
    made distinct, written with save_state and the launcher's
    federation_meta."""
    import dataclasses

    from repro.api import FederationSpec, init_state, save_state
    from repro.launch.train import federation_meta
    from repro.optim import sgd

    jm, _, _, _ = _models("gemma3-4b")
    spec = FederationSpec(n_clients=2, tau=1, loss_fn=lambda p, b: 0.0,
                          optimizer=sgd(0.1), clip_norm=1.0, dp=True,
                          sigmas=(0.5, 0.5), batch_sizes=(2, 2),
                          topology=topology)
    state = init_state(spec, jm.init(jax.random.PRNGKey(3)))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[jm.init(jax.random.PRNGKey(10 + i))
                             for i in range(2)])
    state = dataclasses.replace(state, params=stacked)
    save_state(str(directory), state, extra=federation_meta(spec))


@pytest.mark.parametrize("topology", ["full_average", "local_only"])
def test_federated_checkpoint_serves_jax_tokens(tmp_path, topology):
    _write_jax_checkpoint(tmp_path, topology)
    jm, _, model, _ = _models("gemma3-4b")
    jparams = jax_load_federated_params(jm, str(tmp_path))
    params = serve.load_federated_params(model, str(tmp_path), "cpu")
    # the collapse: replica 0, or the mean of two f32 replicas (one add
    # and one halving in both packages)
    for a, b in zip(jax.tree.leaves(jparams), tree_flatten(params)[0]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    prompts = _prompts(model.cfg.vocab, seed=2)
    want = np.asarray(jax_generate(jm, jparams, jnp.asarray(prompts), GEN))
    for logits in _jax_step_logits(jm, jparams, prompts, want):
        assert _top2_gap(logits) > LOGIT_TOL
    got = serve.generate(model, params, torch.as_tensor(prompts), GEN)
    np.testing.assert_array_equal(got.numpy(), want)


def test_main_prints_the_static_fields(capsys, tmp_path):
    argv = ["--arch", "gemma3-4b", "--smoke", "--static", "--batch", "2",
            "--prompt-len", "8", "--gen", "4", "--device", "cpu"]
    assert serve.main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == "gemma3-4b-smoke" and out["batch"] == 2
    assert out["params"] == "random-init" and out["mode"] == "static"
    assert out["generated_shape"] == [2, 4] and len(out["sample"]) == 4
    assert out["tokens_per_s"] > 0 and "compile_s" in out
    _write_jax_checkpoint(tmp_path, "full_average")
    assert serve.main(argv + ["--fl-checkpoint", str(tmp_path)]) == 0
    assert json.loads(capsys.readouterr().out)["params"] == "federated"


def test_main_engine_mode_prints_the_continuous_fields(capsys):
    """The engine is the default mode; its summary carries the JAX
    launcher's continuous fields."""
    assert serve.main(["--arch", "gemma3-4b", "--smoke", "--batch", "2",
                       "--requests", "3", "--prompt-len", "8", "--gen", "4",
                       "--block-size", "4", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["mode"] == "continuous" and out["batch"] == 2
    assert out["params"] == "random-init"
    assert out["requests"] == 3 and out["tokens_out"] == 12
    assert out["free_slots"] == 2 and out["swaps"] == 0
    for key in ("steps", "occupancy_mean", "compile_s", "duration_s",
                "tokens_per_s", "p50_latency_s", "p99_latency_s",
                "max_queue_depth"):
        assert key in out, key
    assert len(out["sample"]) == 4


def test_main_refuses_the_env_profile_flags(monkeypatch):
    """The mesh profile serves on ``--host-devices`` ranks (the serving
    mesh, tests/test_torch_serve_mesh_launch.py), and refuses before it
    starts a rank a model axis the arch cannot take: query heads it does
    not divide raise ``ValueError`` naming the model axes that do (KV heads
    it does not divide, granite-20b's MQA, are served:
    tests/test_torch_serve_mesh_mqa_launch.py); ``--host-devices``
    over 1 without the mesh profile raises ``ValueError`` naming it.
    ``--env-profile host`` re-execs the launcher once (guarded)."""
    import os
    for extra in ([], ["--env-profile", "host"]):
        with pytest.raises(ValueError, match="--env-profile cpu-mesh"):
            serve.main(["--arch", "gemma3-4b", "--smoke", "--device", "cpu",
                        "--host-devices", "2"] + extra)
    monkeypatch.setenv("REPRO_ENV_PROFILE_APPLIED", "1")     # no re-exec
    ranks = ["--device", "cpu", "--env-profile", "cpu-mesh",
             "--host-devices"]
    with pytest.raises(ValueError, match=r"can be one of \[1, 2, 4\]"):
        serve.main(["--arch", "granite-20b", "--smoke"] + ranks + ["8"])
    with pytest.raises(ValueError, match=r"can be one of \[1, 2, 4\]"):
        serve.main(["--arch", "gemma3-4b", "--smoke"] + ranks + ["3"])
    monkeypatch.delenv("REPRO_ENV_PROFILE_APPLIED", raising=False)
    execs = []

    def fake_exec(exe, argv, env):
        execs.append(env)
        raise SystemExit(0)

    monkeypatch.setattr(os, "execvpe", fake_exec)
    with pytest.raises(SystemExit):
        serve.main(["--arch", "gemma3-4b", "--smoke", "--device", "cpu",
                    "--env-profile", "host"])
    assert len(execs) == 1
    assert execs[0]["REPRO_ENV_PROFILE_APPLIED"] == "1"
