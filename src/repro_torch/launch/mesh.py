"""Device meshes: the production pods and small local meshes.

Counterpart: ``repro/launch/mesh.py``.  Single pod: 256 chips as (data=16,
model=16).  Multi-pod: 2 pods = 512 chips as (pod=2, data=16, model=16); the
``pod`` axis composes with ``data`` for data parallelism, ``model`` stays
inside a pod.  Each mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with those dim names.

``make_local_mesh`` runs on real ranks: the card (NCCL) unless the CPU is
asked for (gloo).  The process group starts from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) when it is set, else as a single
rank on an in-process store; a group started by the caller is used as it
is.  The production meshes run on a *fake* process group of 256 or 512
ranks in one process (as the last rank), which hallucinates every
collective: only
the dry run (``launch/dryrun.py``) uses them, with fake tensors.

Functions, not module constants: importing this module starts no process
group.
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device

FAKE = "fake"


def _register_fake_backend() -> None:
    """Register the ``fake`` backend (PyTorch's ``FakeProcessGroup``) with
    c10d, as ``torch.testing``'s helper does, without importing it."""
    if getattr(_register_fake_backend, "done", False):
        return
    from torch._C._distributed_c10d import FakeProcessGroup

    def create(common_opts, backend_opts):
        make = getattr(FakeProcessGroup, "_create_internal", None)
        if make is not None:
            return make(common_opts.group_rank, common_opts.group_size,
                        backend_opts)
        return FakeProcessGroup(common_opts.group_rank,
                                common_opts.group_size)

    dist.Backend.register_backend(FAKE, create, extended_api=True,
                                  devices=["cpu", "cuda"])
    _register_fake_backend.done = True


def _start(backend: str, world: int) -> None:
    """The default process group: kept if one runs (its backend and world
    size must match), else started."""
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend or dist.get_world_size() != world:
            raise RuntimeError(f"a {have} process group of "
                               f"{dist.get_world_size()} ranks is running; "
                               f"this mesh needs {backend} over {world}")
        return
    if backend == FAKE:
        _register_fake_backend()
        dist.init_process_group(FAKE, store=dist.HashStore(),
                                rank=world - 1, world_size=world)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_fake_mesh(shape: Sequence[int], axes: Tuple[str, ...]) -> DeviceMesh:
    """A CPU mesh of ``shape`` on the fake process group, as its last rank
    (of prod(shape)): traced with fake tensors, never run.  The last rank
    is the busiest: under a sequence split its queries see the longest
    causal prefix."""
    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized() and dist.get_backend() == FAKE \
            and dist.get_world_size() != world:
        dist.destroy_process_group()       # a mesh of another size
    _start(FAKE, world)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_fake_mesh(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1,
                    device: DeviceLike = None) -> DeviceMesh:
    """A (data, model) mesh over the running ranks, on the card (NCCL)
    unless ``device="cpu"`` (gloo); data x model must be the world size.
    On the card each rank takes the device of its ``LOCAL_RANK``."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    world = int(os.environ.get("WORLD_SIZE", 1)) if not dist.is_initialized() \
        else dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; {world} are running")
    _start(backend, world)
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))
