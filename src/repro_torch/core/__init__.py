"""Core of the port: trace model, analytical engine, MLP scorer, predictor.

Kept import-free on purpose: import the modules themselves
(``from repro_torch.core import batched``), so that loading one module
never pulls the whole engine in.
"""
