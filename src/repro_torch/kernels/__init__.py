"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (:mod:`repro_torch.kernels.ref`).

===========================  ===========================================  ================================
kernel                       replaces (Pallas TPU kernel)                 source
===========================  ===========================================  ================================
``dp_clip_noise``            ``repro/kernels/dp_clip_noise.py``           ``csrc/dp_clip_noise.cu``
``quantize_decompress``      ``repro/kernels/quantize_decompress.py``     ``csrc/quantize_decompress.cu``
``cohort_gather_scatter``    ``repro/kernels/cohort_gather.py``           ``csrc/cohort_gather_scatter.cu``
``flash_attention``          ``repro/kernels/flash_attention.py``         ``csrc/flash_attention.cu``
``rwkv6_scan``               ``repro/kernels/rwkv6_scan.py``              ``csrc/rwkv6_scan.cu``
``mamba2_ssd``               ``repro/kernels/mamba2_ssd.py``              ``csrc/mamba2_ssd.cu``
``counter_rng``              none (jax.random's threefry draws by key)    ``csrc/counter_rng.cu``
===========================  ===========================================  ================================

Kernels build with ``nvcc`` at first use (:mod:`repro_torch.kernels._build`)
and launch only on CUDA tensors; CPU tensors take the plain version.
"""
