"""PyTorch/CUDA port of the Habitat reproduction in ``repro``.

Laid out like the JAX package (``repro_torch.core.batched`` pairs with
``repro.core.batched``) and held against it by the ``tests/test_torch_*``
parity tests.  The package imports ``torch`` and numpy only, never
``jax`` and never ``repro``.  Its entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; the MLP scorer's two hand-written Hopper
kernels live in :mod:`repro_torch.kernels.fused_mlp_score`.
"""
