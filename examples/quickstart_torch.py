"""Quickstart on the PyTorch port: DP-PASGD on the (synthetic) Adult
federated split, through ``repro_torch.api``.

The same run as ``examples/quickstart.py``:
  1. build the non-iid federation (16 devices split by education),
  2. solve the optimal design (K*, tau*, sigma*) for the budgets,
  3. declare the run as one FederationSpec, init_state, and train with
     DP-PASGD until a budget binds, reporting accuracy and spent privacy.

Every local step's clip and noise runs through the hand-written
``dp_clip_noise`` CUDA kernel on the GPU (its plain version on the CPU).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

from repro_torch.api import FederationSpec, init_state, train
from repro_torch.core.convergence import ProblemConstants
from repro_torch.core.design import DesignProblem, ResourceModel
from repro_torch.data import adult_like, split_by_group
from repro_torch.models.linear import init_linear, logreg_loss, make_eval_fn
from repro_torch.optim import sgd

C_TH, EPS_TH, DELTA = 1000.0, 4.0, 1e-4
BATCH, LR, CLIP = 32, 0.3, 1.0

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; cpu without a GPU)")
args = ap.parse_args()

print("== 1. data: non-iid Adult-like federation (split by education) ==")
ds = adult_like(n=8000, dim=40)
fed_data = split_by_group(ds)
print(f"   {fed_data.n_clients} clients, "
      f"sizes {[c.n_train for c in fed_data.clients][:6]}...")

print("== 2. optimal schematic design (paper Eq. 21-25) ==")
consts = ProblemConstants(eta=LR, lam=0.1, lip=0.3, alpha=0.8, xi2=0.05,
                          dim=2 * 40 + 2, n_clients=fed_data.n_clients)
problem = DesignProblem(
    consts=consts, resource=ResourceModel(c1=100.0, c2=1.0),
    clip_norm=CLIP, batch_sizes=fed_data.batch_sizes(BATCH),
    delta=DELTA, eps_th=EPS_TH, c_th=C_TH)
sol = problem.solve()
print(f"   K*={sol.k}  tau*={sol.tau}  sigma*={sol.sigmas[0]:.4f}  "
      f"predicted bound={sol.predicted_bound:.4f}  cost={sol.cost:.0f}")

print(f"== 3. train DP-PASGD on {args.device} until the budgets bind ==")
spec = FederationSpec(
    n_clients=fed_data.n_clients, tau=sol.tau,
    loss_fn=logreg_loss, optimizer=sgd(LR),
    clip_norm=CLIP, dp=True, engine="auto",
    sigmas=tuple(float(s) for s in sol.sigmas),
    batch_sizes=tuple(fed_data.batch_sizes(BATCH)),
    eps_th=EPS_TH, delta=DELTA, c_th=C_TH)
state = init_state(spec, init_linear(40, device=args.device),
                   device=args.device)
xt, yt = fed_data.eval_arrays("test")
state, out = train(spec, state, fed_data.make_sampler(BATCH),
                   max_rounds=sol.k // sol.tau,
                   eval_fn=make_eval_fn(logreg_loss, xt, yt))
print(f"   rounds={out['rounds']}  best acc={out['best'].get('eval_acc'):.4f}"
      f"  spent eps={out['max_epsilon']:.3f} (budget {EPS_TH})"
      f"  spent C={out['resource_spent']:.0f} (budget {C_TH})")
if out["max_epsilon"] > EPS_TH + 1e-6:
    raise SystemExit(f"spent eps {out['max_epsilon']} exceeds {EPS_TH}")
