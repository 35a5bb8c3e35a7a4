"""Static serving driver: one batch through ``prefill``, then one
``decode_step`` per generated token (a port of the static path of the JAX
package's ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Serving a federated model: ``--fl-checkpoint DIR`` points at a checkpoint
written with the training launcher's ``federation_meta`` beside it, by the
port's own launcher (``python -m repro_torch.launch.train ... --save DIR``,
dense, population or async) or by the JAX package's (``repro.launch.train``
/ ``repro.api.save_state``); the driver serves the aggregated model instead
of random init. The continuous-batching engine (the JAX
launcher's default mode) is not ported yet: ``--engine`` raises.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_variant
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
             prefix=None, temperature: float = 0.0, generator=None):
    """prompts (B, S) integer -> generated (B, gen_tokens) int64.

    Batch ``prefill`` of the prompts (and ``prefix`` embeddings, for the
    prefix-conditioned archs), then per token: the argmax of the last
    logits (``temperature == 0``) or a ``torch.multinomial`` draw from
    ``softmax(logits / temperature)`` with ``generator``, then one
    ``decode_step``, as the JAX package's loop does. Runs under
    ``torch.inference_mode()``."""
    with torch.inference_mode():
        b, s = prompts.shape
        max_len = s + gen_tokens + (model.cfg.prefix_len or 0)
        logits, caches, pos = model.prefill(params, prompts, prefix,
                                            max_len=max_len)
        outs = []
        for i in range(gen_tokens):
            tok = _sample(logits, temperature, generator)
            logits, caches = model.decode_step(params, caches, tok, pos + i)
            outs.append(tok)
        return torch.stack(outs, dim=1)


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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", action="store_true",
                    help="continuous batching (not ported yet: raises)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--fl-checkpoint", default=None,
                    help="serve the aggregated model of a checkpoint "
                         "written by repro_torch.launch.train --save (or "
                         "the JAX launcher's) instead of random init")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.engine:
        raise NotImplementedError(
            "the continuous-batching engine (repro/serve) is not ported "
            "yet; the static path is the default")

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
    result = _run_static(model, params, args, cfg, device)
    print(json.dumps({
        "arch": cfg.name, "batch": args.batch,
        "params": "federated" if args.fl_checkpoint else "random-init",
        **result,
    }, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
