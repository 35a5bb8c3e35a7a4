from repro_torch.optim.optimizers import Optimizer, adamw, momentum, sgd
from repro_torch.optim.schedules import constant, cosine_decay, linear_warmup

__all__ = [
    "Optimizer", "sgd", "momentum", "adamw",
    "constant", "cosine_decay", "linear_warmup",
]
