"""Hand-written Hopper kernels of the port, each beside its plain version.

``fused_mlp_score`` holds the two MLP scorer kernels (CUDA C++ under
``csrc/``, built by :mod:`repro_torch.kernels.build`).
"""
