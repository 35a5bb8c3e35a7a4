"""Continuous-batching serving plane: slot engine, paged KV cache
scheduling, and federated checkpoint hot-swap (a port of the JAX package's
``repro/serve``)."""
from repro_torch.serve.engine import SlotEngine, model_pads_ok
from repro_torch.serve.requests import Request, poisson_workload
from repro_torch.serve.scheduler import (
    ServeReport,
    StepClock,
    WallClock,
    serve_continuous,
    serve_static,
)

__all__ = [
    "Request",
    "ServeReport",
    "SlotEngine",
    "StepClock",
    "WallClock",
    "model_pads_ok",
    "poisson_workload",
    "serve_continuous",
    "serve_static",
]
