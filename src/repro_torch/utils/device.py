"""The device rule of the port's entry points: the GPU unless the caller
asks for another device."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    Raises when CUDA is asked for (explicitly or by default) and no GPU is
    present, instead of quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


_CONSTS: dict = {}
_CONSTS_MAX = 64


def device_constant(values: tuple, device,
                    dtype=torch.int64) -> torch.Tensor:
    """The tuple ``values`` as a ``dtype`` tensor on ``device``, copied up
    once per (values, device, dtype) and kept (a steady round copies no
    row ids or column tables to the device). The cache is small: it is
    emptied when it holds 64 tensors."""
    key = (values, str(device), dtype)
    t = _CONSTS.get(key)
    if t is None:
        if len(_CONSTS) >= _CONSTS_MAX:
            _CONSTS.clear()
        t = _CONSTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t
