"""Device meshes over the process group.

Counterpart of ``repro.launch.mesh``. Functions, not module constants, so
importing this module starts no process group. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over every rank of the
default group; with no group initialized, ``ensure_process_group`` starts
one: from the ``torchrun`` environment when it is set, else a one-rank
group on a free local port (``nccl`` on ``cuda``, ``gloo`` on ``cpu``).
"""

from __future__ import annotations

import math
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve_device


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ensure_process_group(device: DeviceLike = "cuda") -> str:
    """The default group's backend, starting a group if there is none."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                                    rank=0, world_size=1)
    return dist.get_backend()


def _mesh(device: DeviceLike, shape, names) -> DeviceMesh:
    dev = resolve_device(device)
    ensure_process_group(dev)
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = "cuda") -> DeviceMesh:
    """(data 16, model 16), or (pod 2, data 16, model 16) with
    ``multi_pod``: only on a world of 256 / 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, names)


def make_host_mesh(model: int = 1, device: DeviceLike = "cuda") -> DeviceMesh:
    """(data world // model, model) over every rank, the model axis clamped
    to the world's size: on one rank ``model=2`` gives a (1, 1) mesh."""
    ensure_process_group(device)
    n = dist.get_world_size()
    model = min(model, n)
    return _mesh(device, (n // model, model), ("data", "model"))
