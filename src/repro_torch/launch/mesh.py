"""Device meshes on ``torch.distributed`` (port of ``repro.launch.mesh``).

Functions, not module constants: importing this module starts no process
group.  Both return a ``torch.distributed.device_mesh.DeviceMesh`` with
the reference's axis names.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import resolve_device


def _backend(dev: torch.device) -> str:
    # on the card: nccl for its tensors and gloo for CPU ones, so a CPU
    # copy of a step can run beside it in the same world
    return "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo"


def ensure_world(device="cuda") -> None:
    """Start a process group of one rank unless one exists.  The
    rendezvous is an in-process ``HashStore`` (no TCP); the backend is
    ``nccl`` for the card's tensors and ``gloo`` on the CPU.  A launcher
    of several ranks starts its own group first (a ``FileStore``, or
    ``tcp://localhost:<port>``) and this leaves it as it is."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(_backend(dev), store=dist.HashStore(), rank=0,
                            world_size=1)


def _mesh(device, shape: tuple[int, ...], names: tuple[str, ...]):
    dev = resolve_device(device)
    ids = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(dev.type, ids, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production layout: ``(16, 16)`` over ("data",
    "model"), or ``(2, 16, 16)`` over ("pod", "data", "model").  Raises
    unless the process group has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != math.prod(shape):
        raise RuntimeError(
            f"the production mesh {shape} needs {math.prod(shape)} ranks; "
            f"the process group has {world}")
    return _mesh(device, shape, names)


def make_host_mesh(model: int = 1, *, device="cuda"):
    """Whatever this job actually has: ``(world // model, model)`` over
    ("data", "model"), starting a world of one (:func:`ensure_world`)
    where no process group exists."""
    ensure_world(device)
    n = dist.get_world_size()
    assert n % model == 0, (n, model)
    return _mesh(device, (n // model, model), ("data", "model"))
