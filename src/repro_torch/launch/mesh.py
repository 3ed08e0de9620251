"""Mesh construction — the port of ``repro/launch/mesh.py``'s
``make_zero_mesh`` and ``make_host_mesh``, on ``torch.distributed``.

The port is SPMD: one process a rank, each running the same calls. A mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
"model")`` over the default process group, which the caller initialises
(``torch.distributed.init_process_group`` with its store or address, world
size and rank). Nothing here picks a backend or falls back from one to
another: ``device="cuda"`` expects an NCCL group, ``"cpu"`` a gloo one, and
a caller that wants gloo on CUDA tensors says so (``backend="gloo"``).
The reference's TPU constants (``:47-53``) are not copied.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_zero_mesh(ndp: int = 1, *, model: int = 1, device: str = "cuda",
                   backend: Optional[str] = None):
    """A ``(data=ndp, model=model)`` DeviceMesh over the first ``ndp *
    model`` ranks of the initialised default group, for tensors on
    ``device``. ``backend`` is the group's backend the caller expects
    (``nccl`` for ``cuda``, ``gloo`` for ``cpu`` unless given); a group
    with another backend raises."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_zero_mesh needs an initialised process group: call "
            "torch.distributed.init_process_group(backend, store=... or "
            "init_method=..., world_size=..., rank=...) on every rank")
    device = torch.device(device).type
    want = backend or BACKENDS.get(device)
    got = dist.get_backend()
    if want is None or got != want:
        raise ValueError(f"a {device} mesh expects the {want} backend; the "
                         f"default group runs {got}")
    n = ndp * model
    if dist.get_world_size() < n:
        raise ValueError(f"a ({ndp} x {model}) mesh needs {n} ranks; the "
                         f"group has {dist.get_world_size()}")
    ranks = torch.arange(n).reshape(ndp, model)
    return DeviceMesh(device, ranks, mesh_dim_names=("data", "model"))


def make_host_mesh():
    """The degenerate 1-rank mesh for runs on the CPU (gloo)."""
    return make_zero_mesh(1, device="cpu")
