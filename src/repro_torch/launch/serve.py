"""Serving driver: the continuous-batching engine (``repro_torch.serve``)
by default, the static prefill + decode batch kept as the ``--static``
baseline (a port of the JAX package's ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --smoke --requests 8 --prompt-len 32 --gen 16 [--device cpu]

The engine mode serves a Poisson workload of ``--requests`` requests at
``--rate`` per simulated second on ``--batch`` slots (paged KV blocks of
``--block-size``) and prints the scheduler's summary; ``--static`` runs one
batch through ``prefill``, then one ``decode_step`` per generated token
(forced for prefix-conditioned archs). ``--env-profile host`` re-execs the
launcher once under tcmalloc (:mod:`repro_torch.launch.env`);
``--env-profile cpu-mesh`` and ``--host-devices`` above 1 raise (ROADMAP
queue 1 item 12).

Serving a federated model: ``--fl-checkpoint DIR`` points at a checkpoint
written with the training launcher's ``federation_meta`` beside it, by the
port's own launcher (``python -m repro_torch.launch.train ... --save DIR``,
dense, population or async) or by the JAX package's (``repro.launch.train``
/ ``repro.api.save_state``); the driver serves the aggregated model instead
of random init.

Both paths warm up before the timed run, so ``tokens_per_s`` is steady
state; the warm-up (on a GPU the kernels' build, cuBLAS handles and the
allocator) is reported as ``compile_s``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_variant
from repro_torch.launch.env import add_env_profile_args, apply_env_profile
from repro_torch.models.transformer import Transformer
from repro_torch.utils.device import resolve_device


def load_federated_params(model: Transformer, directory: str, device=None):
    """The single serving model out of a DP-PASGD checkpoint directory.

    Reads the spec scalars the training launcher stored next to the arrays
    (``federation_meta``) and loads only the params leaves, so checkpoints
    from any optimizer and any compressor serve alike. The client axis
    collapses as ``collapse_clients`` does: any replica under
    ``full_average``, the cross-client mean under ``local_only``. A
    buffered-async checkpoint stores the collapsed server model under
    ``global_params``: that is served, never its in-flight slot storages.
    Returns the params on ``device`` (default: the GPU) in the config's
    dtypes, checked leaf by leaf against the model's own init."""
    from repro_torch.api import collapse_clients
    from repro_torch.checkpoint import checkpoint_leaf_paths, load_checkpoint
    from repro_torch.utils.convert import transformer_params_from_jax

    device = resolve_device(device)
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)["extra"]
    # path donor only: load_checkpoint matches leaves by path
    donor = model.init(device="meta")
    if any(p.split("/", 1)[0] == "global_params"
           for p in checkpoint_leaf_paths(directory)):
        tree, _, _ = load_checkpoint(directory, like={"global_params": donor})
        return transformer_params_from_jax(tree["global_params"], model,
                                           device)
    tree, _, _ = load_checkpoint(directory, like={"params": donor})
    stacked = transformer_params_from_jax(tree["params"], model, device,
                                          lead=1)
    return collapse_clients(stacked, meta.get("topology", "full_average"))


def _sample(logits, temperature: float, generator):
    if temperature > 0:
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


def generate(model: Transformer, params, prompts, gen_tokens: int,
             prefix=None, temperature: float = 0.0, generator=None,
             with_logits: bool = False):
    """prompts (B, S) integer -> generated (B, gen_tokens) int64.

    Batch ``prefill`` of the prompts (and ``prefix`` embeddings, for the
    prefix-conditioned archs), then per token: the argmax of the last
    logits (``temperature == 0``) or a ``torch.multinomial`` draw from
    ``softmax(logits / temperature)`` with ``generator``, then one
    ``decode_step``, as the JAX package's loop does. Runs under
    ``torch.inference_mode()``. ``with_logits``: also return the logits
    each token was drawn from, (B, gen_tokens, V) f32 (the reference of
    :func:`agree_under_gap`)."""
    with torch.inference_mode():
        b, s = prompts.shape
        max_len = s + gen_tokens + (model.cfg.prefix_len or 0)
        logits, caches, pos = model.prefill(params, prompts, prefix,
                                            max_len=max_len)
        outs, seen = [], []
        for i in range(gen_tokens):
            tok = _sample(logits, temperature, generator)
            if with_logits:
                seen.append(logits.to(torch.float32))
            logits, caches = model.decode_step(params, caches, tok, pos + i)
            outs.append(tok)
        out = torch.stack(outs, dim=1)
        return (out, torch.stack(seen, dim=1)) if with_logits else out


def agree_under_gap(tokens, ref_tokens, ref_logits, tol: float):
    """Greedy tokens held against a reference's where an argmax is well
    defined: step by step while the reference's top-two logit gap exceeds
    ``tol`` (logits that differ by less than tol / 2 cannot flip such an
    argmax). Two paths whose logits differ only by rounding (another batch
    shape, a padded prefill, a longer masked span) agree there.

    tokens / ref_tokens (G,) sequences; ref_logits (G, V). Returns
    ``(agree, steps compared)``: compared == G means compared in full."""
    ref_logits = torch.as_tensor(ref_logits).to(torch.float32)
    top2 = torch.topk(ref_logits, 2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).cpu().tolist()
    ref = [int(t) for t in ref_tokens]
    got = [int(t) for t in tokens]
    for i, gap in enumerate(gaps):
        if gap <= tol:
            return got[:i] == ref[:i], i
    return got == ref, len(gaps)


def _run_static(model, params, args, cfg, device):
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len)),
        device=device)
    prefix = None
    if cfg.prefix_len:
        prefix = torch.as_tensor(
            rng.standard_normal((args.batch, cfg.prefix_len, cfg.d_model)),
            dtype=torch.float32, device=device) * 0.02

    def run():
        gen = torch.Generator(device=device).manual_seed(0)
        out = generate(model, params, prompts, args.gen, prefix,
                       args.temperature, gen)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    t0 = time.perf_counter()
    run()
    t1 = time.perf_counter()
    out = run()
    t2 = time.perf_counter()
    steady = t2 - t1
    return {
        "mode": "static",
        "generated_shape": list(out.shape),
        "tokens_per_s": round(args.batch * args.gen / steady, 1),
        "compile_s": round((t1 - t0) - steady, 3),
        "sample": out[0, :8].tolist(),
    }


def _run_engine(model, params, args, cfg, device):
    from repro_torch.serve import (SlotEngine, poisson_workload,
                                   serve_continuous)

    max_len = args.prompt_len + args.gen
    engine = SlotEngine(model, params, n_slots=args.batch, max_len=max_len,
                        block_size=args.block_size,
                        temperature=args.temperature, device=device)
    workload = poisson_workload(args.requests, args.rate, cfg.vocab,
                                prompt_lens=(args.prompt_len,),
                                gen_lens=(args.gen,))
    engine.warmup(buckets=[r.prompt_len for r in workload])
    report = serve_continuous(engine, workload)
    first = report.requests[0]
    return {
        "mode": "continuous",
        **report.summary(),
        "sample": first.out[:8],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--static", action="store_true",
                    help="pre-engine baseline: one static prefill+decode "
                         "batch (forced for prefix-conditioned archs)")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (engine) / batch rows (static)")
    ap.add_argument("--requests", type=int, default=8,
                    help="workload size of the engine mode")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="Poisson arrival rate (requests/sim-second)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--block-size", type=int, default=0,
                    help="paged KV block length (0: one block per slot)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--fl-checkpoint", default=None,
                    help="serve the aggregated model of a checkpoint "
                         "written by repro_torch.launch.train --save (or "
                         "the JAX launcher's) instead of random init")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    add_env_profile_args(ap)
    args = ap.parse_args(argv)
    apply_env_profile(args.env_profile, host_devices=args.host_devices)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    model = Transformer(cfg)
    if args.fl_checkpoint:
        params = load_federated_params(model, args.fl_checkpoint, device)
    else:
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            device)
    if args.static or cfg.prefix_len:
        result = _run_static(model, params, args, cfg, device)
    else:
        result = _run_engine(model, params, args, cfg, device)
    print(json.dumps({
        "arch": cfg.name, "batch": args.batch,
        "params": "federated" if args.fl_checkpoint else "random-init",
        **result,
    }, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
