"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (:mod:`repro_torch.kernels.ref`).

===========================  ===========================================  ================================
kernel                       replaces (Pallas TPU kernel)                 source
===========================  ===========================================  ================================
``dp_clip_noise``            ``repro/kernels/dp_clip_noise.py``           ``csrc/dp_clip_noise.cu``
``quantize_decompress``      ``repro/kernels/quantize_decompress.py``     ``csrc/quantize_decompress.cu``
``cohort_gather_scatter``    ``repro/kernels/cohort_gather.py``           ``csrc/cohort_gather_scatter.cu``
===========================  ===========================================  ================================

Kernels build with ``nvcc`` at first use (:mod:`repro_torch.kernels._build`)
and launch only on CUDA tensors; CPU tensors take the plain version.
"""
