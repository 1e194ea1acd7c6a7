"""Hand-written Hopper kernels of the port, each beside its plain version.

``fused_mlp_score`` holds the two multi-kind MLP scorer kernels,
``fused_mlp`` the single-MLP chain, ``flash_attention`` and ``ssd`` the LM
kernels (CUDA C++ under ``csrc/``, built by
:mod:`repro_torch.kernels.build`).
"""
