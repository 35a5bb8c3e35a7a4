"""PyTorch/CUDA port of the DP-PASGD system.

Mirrors ``src/repro`` subpackage by subpackage; the public entry point is
:mod:`repro_torch.api`. The port never imports ``jax`` or ``repro``.
"""
