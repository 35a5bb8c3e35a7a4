"""Batched serving example on the PyTorch port: prefill a batch of prompts
on reduced zamba2 / rwkv6 / gemma3-family models and decode with the cached
state, exercising the hybrid KV / SSM cache path (``examples/
serve_batched.py`` on ``repro_torch``).

The final section runs the whole federated loop through the
``repro_torch.api`` facade: a tiny gemma3 federation takes two DP-PASGD
rounds under the aggregation pipeline (half the clients sampled per round,
top-k compressed updates with error feedback), checkpoints its ``FLState``
with ``save_state``, and the serving driver reloads the aggregated model
via ``load_federated_params``: train to serve through the port's public
entry points.

Run:  PYTHONPATH=src python examples/serve_batched_torch.py [--device cpu]
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.api import (FederationSpec, init_state, materialize_record,
                             run_round, save_state)
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.data.tokens import FederatedTokenStream, TokenTaskConfig
from repro_torch.launch.serve import generate, load_federated_params
from repro_torch.launch.train import federation_meta
from repro_torch.models.transformer import Transformer
from repro_torch.optim import sgd
from repro_torch.utils.tree import tree_map

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; cpu without a GPU)")
args = ap.parse_args()
device = torch.device(args.device)

for arch in ("zamba2-7b", "rwkv6-1.6b", "gemma3-4b"):
    cfg = smoke_variant(get_arch(arch))
    model = Transformer(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, device)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, size=(4, 24)),
                              device=device)
    t0 = time.time()
    out = generate(model, params, prompts, gen_tokens=12, temperature=0.8,
                   generator=gen)
    dt = time.time() - t0
    assert out.shape == (4, 12)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab
    print(f"{arch:>14}: generated {tuple(out.shape)} in {dt:.1f}s on "
          f"{device}; sample={out[0, :6].tolist()}")

# ---- federate -> checkpoint -> serve (the repro_torch.api loop) ------------
C, TAU, BATCH, SEQ = 4, 2, 2, 16
cfg = smoke_variant(get_arch("gemma3-4b"))
model = Transformer(cfg)
spec = FederationSpec(
    n_clients=C, tau=TAU, loss_fn=model.loss_fn, optimizer=sgd(0.05),
    dp=True, clip_norm=5.0, sigmas=(0.01,) * C, batch_sizes=(BATCH,) * C,
    participation=0.5, compressor="topk", compression_ratio=0.25)
stream = FederatedTokenStream(TokenTaskConfig(vocab=cfg.vocab, seq_len=SEQ,
                                              n_clients=C, seed=0),
                              BATCH, prefix_len=cfg.prefix_len,
                              d_model=cfg.d_model)
state = init_state(spec, model.init(
    torch.Generator(device=device).manual_seed(0), device), device=device)
rng = np.random.default_rng(0)
for _ in range(2):
    per_client = [stream.sampler(m, TAU, rng) for m in range(C)]
    batch = tree_map(lambda *xs: np.stack(xs), *per_client)
    state, rec = run_round(spec, state, batch, check_budgets=False)
rec = materialize_record(rec)
print(f"federated 2 rounds (q=0.5, topk 25%): loss={rec['loss']:.3f} "
      f"participants/round={int(rec['participants'])} "
      f"comm cost x{spec.comm_scale():.3f}")

with tempfile.TemporaryDirectory() as ckpt:
    save_state(ckpt, state, extra=federation_meta(spec))
    served = load_federated_params(model, ckpt, device)
prompts = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 12)),
                          device=device)
out = generate(model, served, prompts, gen_tokens=8, temperature=0.8,
               generator=torch.Generator(device=device).manual_seed(1))
assert out.shape == (2, 8)
print(f"served the aggregated federated model: sample="
      f"{out[0, :6].tolist()}")
