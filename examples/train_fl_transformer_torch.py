"""End-to-end driver on the PyTorch port: federated DP-PASGD training of a
~100M-param transformer on the synthetic non-iid token task, through
``repro_torch.launch.train.build_federation`` and ``repro_torch.api``.

The same run as ``examples/train_fl_transformer.py``: C clients each take
tau local noisy-SGD steps on their own token distribution, then average.
Default config (~110M params: gemma3-family, 6 layers, d=768); pass --tiny
for a sanity run of a 1.7M-param model (20 rounds, ~20 s on a CPU). Every local step's clip and noise
runs through the hand-written ``dp_clip_noise`` CUDA kernel on the GPU (its
plain version on the CPU); the model trains on its differentiable route.

Run:  PYTHONPATH=src python examples/train_fl_transformer_torch.py --tiny \\
          [--device cpu]
"""
import argparse
import time
from dataclasses import replace

import torch

from repro_torch.api import train
from repro_torch.configs import get_arch
from repro_torch.configs.base import LayerSpec, Segment
from repro_torch.core.privacy import sigma_star
from repro_torch.launch.train import build_federation
from repro_torch.utils.tree import tree_leaves

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--tiny", action="store_true")
ap.add_argument("--rounds", type=int, default=0)
ap.add_argument("--engine", default="auto", choices=("vmap", "map", "auto"))
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; cpu without a GPU)")
args = ap.parse_args()

base = get_arch("gemma3-4b")
if args.tiny:
    cfg = replace(
        base, name="gemma3-tiny", d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=512, vocab=2048, n_layers=6, window=64,
        segments=(Segment(1, (LayerSpec(attn_kind="swa"),) * 5
                          + (LayerSpec(attn_kind="full"),)),),
        loss_chunk=0, block_q=64, dtype="float32", remat=False)
    # the loss falls slowly at this noise level, by about its batch-to-batch
    # spread in 8 rounds (the JAX example's count): 20 clear it
    rounds = args.rounds or 20
    batch, seq, tau = 8, 64, 4
else:
    # ~110M params: 6-layer gemma3-family stack, d=768, 32k vocab
    cfg = replace(
        base, name="gemma3-110m", d_model=768, n_heads=12, n_kv_heads=4,
        head_dim=64, d_ff=3072, vocab=32768, n_layers=6, window=256,
        segments=(Segment(1, (LayerSpec(attn_kind="swa"),) * 5
                          + (LayerSpec(attn_kind="full"),)),),
        loss_chunk=0, block_q=128, dtype="float32", remat=False)
    rounds = args.rounds or 50
    batch, seq, tau = 8, 256, 8

DELTA, C = 1e-5, 4
K = rounds * tau
if args.tiny:
    # At toy scale, per-coordinate DP noise at a practical eps swamps the
    # signal (the paper's accuracy-privacy trade-off); the tiny demo uses a
    # weak privacy level and reports the eps it actually spends.
    CLIP, sigma, EPS = 20.0, 0.1, float("inf")
else:
    CLIP, EPS = 1.0, 8.0
    sigma = sigma_star(K, CLIP, batch, EPS, DELTA)
print(f"arch={cfg.name} clients={C} tau={tau} rounds={rounds} "
      f"sigma={sigma:.4f} (eps budget={EPS}) device={args.device}")

model, spec, state, sampler = build_federation(
    cfg, n_clients=C, tau=tau, batch_size=batch, seq_len=seq,
    sigmas=[sigma] * C, lr=0.05, clip_norm=CLIP, delta=DELTA,
    engine=args.engine, device=args.device)
spec = spec.replace(eps_th=EPS)
n_params = sum(x.numel() for x in tree_leaves(state.params)) // C
print(f"params/client: {n_params/1e6:.1f}M")

t0 = time.time()
state, out = train(spec, state, sampler, max_rounds=rounds)
if torch.device(args.device).type == "cuda":
    torch.cuda.synchronize()
losses = [h["loss"] for h in out["history"]]
print(f"iterations={out['rounds'] * tau}  loss {losses[0]:.3f} -> "
      f"best {min(losses):.3f}  eps spent={out['max_epsilon']:.3f}  "
      f"wall={time.time()-t0:.0f}s")
assert min(losses) < losses[0], "DP-PASGD should reduce training loss"
