"""Device-mesh factories, as ``repro.launch.mesh``.

Each builds a ``torch.distributed`` ``DeviceMesh`` over the caller's
process group, one rank per device: NCCL on the card, gloo on the CPU,
and the mesh's device type follows the group's backend. None of them
starts a group; start it first (``torchrun`` does, or
``torch.distributed.init_process_group`` with an address, the world size
and the rank). Kept as functions, so importing this module touches no
device and no group.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type() -> str:
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            "no torch.distributed process group: call "
            "torch.distributed.init_process_group (backend 'nccl' on GPUs, "
            "'gloo' on the CPU) or run under torchrun before building a "
            "mesh")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the first prod(shape) ranks
    of the group (the world must have exactly that many)."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    dev = _device_type()
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size()
    if need != have:
        raise ValueError(
            f"mesh {'x'.join(map(str, shape))} {tuple(axes)} needs {need} "
            f"ranks, the process group has {have} (start one process per "
            f"device, e.g. torchrun --nproc-per-node {need})")
    return init_device_mesh(dev, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's production mesh: 16x16 (256 devices) or 2 pods =
    512; raises on any smaller world."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh() -> DeviceMesh:
    """A one-rank mesh (axes present, size 1)."""
    return make_mesh((1, 1), ("data", "model"))


def make_serving_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """Serving mesh: ``data`` carries slot-pool sharding (DESIGN.md §8),
    ``model`` carries TP."""
    return make_mesh((data, model), ("data", "model"))
