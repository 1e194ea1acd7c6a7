"""Mesh construction (port of ``repro.launch.mesh``).

Defined as FUNCTIONS (not module constants) so importing this module never
touches the process group.  A mesh is a ``DeviceMesh`` over the current
``torch.distributed`` process group (the caller runs
``init_process_group``: NCCL on the cards, gloo on the CPU), with the
reference's axis names.  The single-pod production mesh is 16 x 16 = 256
ranks; the multi-pod mesh adds a leading "pod" axis (2 x 16 x 16 = 512).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.core.devices import torch_device


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group before building a mesh")
    return dist.get_world_size()


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None):
    """``init_device_mesh`` of ``shape`` named ``axes`` over the process
    group's ranks, on ``device``'s type (default ``cuda``; ``"cpu"`` for
    a gloo group).  The group's world size must be the mesh's size."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    world = _world_size()
    if n != world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process "
                         f"group has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch_device(device).type, shape,
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_smoke_mesh(n_devices: int = None, model: int = 2, device=None):
    """A small (data, model) mesh over the process group's ranks (tests)."""
    n = n_devices or _world_size()
    model = min(model, n)
    return make_mesh((n // model, model), ("data", "model"), device)
