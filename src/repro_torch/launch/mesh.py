"""Mesh construction (port of ``repro.launch.mesh``) on torch's
``DeviceMesh``.

A ``DeviceMesh`` needs the process's default process group to cover it,
and a process holds one default group.  So each mesh here comes from a
context manager that starts the group on entry and destroys it on exit,
and refuses to start one while another is alive:

* :func:`make_production_mesh`: the 16 x 16 ``("data", "model")`` pod,
  or 2 x 16 x 16 ``("pod", "data", "model")``, over torch's fake process
  group of 256 or 512 ranks, this process rank 0.  The fake group moves
  no data: it is for shape-only work on the meta device (the dry-run),
  the counterpart of the reference's 512 placeholder host devices.
* :func:`make_host_mesh`: the 1 x 1 mesh, on CUDA unless the caller asks
  for the CPU: NCCL with world size 1 on the card, gloo with world size
  1 on the CPU.  Both groups rendezvous through an in-process store, so
  nothing opens a port.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


@contextlib.contextmanager
def _group_mesh(backend: str, store, device_type: str, shape: tuple,
                axes: tuple) -> Iterator[DeviceMesh]:
    """Start the default group (``backend``, rank 0 of ``prod(shape)``),
    yield the mesh over it, destroy the group on exit."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is already alive in "
                           "this process; a mesh needs its own")
    world = 1
    for n in shape:
        world *= n
    dist.init_process_group(backend, store=store, rank=0, world_size=world)
    try:
        yield init_device_mesh(device_type, shape, mesh_dim_names=axes)
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """Context manager: 16x16 chips per pod, 2 pods when ``multi_pod``,
    over the fake process group (starts it, destroys it on exit)."""
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _group_mesh("fake", FakeStore(), "cpu", shape, axes)


def data_axes(mesh) -> tuple:
    """Mesh axes that carry the batch (pod+data when present)."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def make_host_mesh(device=None):
    """Context manager: the 1x1 ``("data", "model")`` mesh on ``device``
    (CUDA unless the caller asks for the CPU): NCCL on the card, gloo on
    the CPU, world size 1 (starts the group, destroys it on exit)."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    return _group_mesh(backend, dist.HashStore(), dev.type, (1, 1),
                       ("data", "model"))
