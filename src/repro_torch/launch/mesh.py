"""Production mesh construction (``repro.launch.mesh`` twin), as DTensor
``DeviceMesh``es over the default process group.

single pod : (16, 16)    axes ("data", "model")        = 256 ranks
multi pod  : (2, 16, 16) axes ("pod", "data", "model") = 512 ranks

Defined as functions, so importing this module touches no process group.
The caller starts one first: the dry-run a fake group of the mesh's size
(``launch/dryrun.py``), a run on the card a real one.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import resolve_device


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, the process group has {world}; "
            "launch via launch/dryrun.py, which starts a fake group of the mesh's size")
    return DeviceMesh(device, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_host_mesh(device: str = "cuda") -> DeviceMesh:
    """Degenerate (1, 1) mesh on this rank's device, over the default process
    group (one rank of it)."""
    dev = resolve_device(device)
    return DeviceMesh(dev.type, torch.tensor([[dist.get_rank()]]),
                      mesh_dim_names=("data", "model"))
