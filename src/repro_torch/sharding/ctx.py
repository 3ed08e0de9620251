"""Ambient mesh and activation hints — the port of
``repro/sharding/ctx.py``.

``use_mesh(mesh)`` scopes the ambient mesh: a ``ShardedContext``, a
``DeviceMesh``, a ``SpecMesh``, a ``sharding.tp.TensorParallel`` or None.
Under a mesh whose ``model`` axis is above 1 the model runs tensor
parallel (``sharding.tp.current()`` reads the group from it), as the
reference's model bakes its hints in under ``use_mesh``.

Model code may call ``constrain(x, "dp", None, "model")`` at an activation.
In the reference that is a GSPMD hint; the port runs SPMD with explicit
collectives (the Megatron operators of ``sharding/tp.py``), so on a
DP-only mesh every activation is whole on its rank and ``constrain`` and
``constrain_spec`` return their input; on a mesh with a model axis above 1
a hint has no meaning here and raises.

``dp_size`` reads the ambient mesh's data-parallel domain, which the MoE
FFN routes over (``models/moe.py``: one routing group a DP shard, as the
reference's ``_num_dp_shards``).

``resolve_entry`` resolves a hint entry against a mesh as the reference
does ("dp" -> the DP axes present, "model" -> itself, a non-divisible dim
-> None). ``segment_param_specs`` is the ambient per-layer gather hook:
``Model._stack_fwd`` reads it when no ``layer_specs`` is passed (a
``TreePlan.layer_specs``, whose ``gather(i, layer)`` gathers layer i).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

from repro_torch.sharding.rules import DP_AXIS_NAMES, MODEL_AXIS

_MESH = None


def set_current_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def current_mesh():
    return _MESH


@contextmanager
def use_mesh(mesh):
    """Scoped ambient mesh (any of the module docstring's kinds);
    ``use_mesh(None)`` is the explicit no-mesh scope."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def dp_size(mesh=None) -> int:
    """The size of the DP axes of ``mesh`` (by default the ambient one):
    a ``ShardedContext``'s ``ndp``, the product of a ``SpecMesh``'s or a
    ``DeviceMesh``'s DP axes; 1 without a mesh or for a TP group alone."""
    mesh = _MESH if mesh is None else mesh
    if mesh is None:
        return 1
    if hasattr(mesh, "spec_mesh"):
        return mesh.ndp
    if not hasattr(mesh, "shape"):
        return 1
    shape = _shape(mesh)
    return _axsize(mesh, tuple(a for a in DP_AXIS_NAMES if a in shape))


def _shape(mesh) -> dict:
    """name -> size of a SpecMesh or a DeviceMesh."""
    if isinstance(mesh.shape, dict):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _names(mesh):
    return tuple(_shape(mesh))


def _axsize(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= _shape(mesh)[a]
    return n


def resolve_entry(mesh, entry, dim: int):
    """Resolve a hint entry against ``mesh``: "dp" -> the DP axis names
    present, "model" or any axis name -> itself; absent or non-divisible
    -> None (whole)."""
    if entry is None:
        return None
    names = _names(mesh)
    if entry == "dp":
        axes = tuple(a for a in DP_AXIS_NAMES if a in names)
        if not axes:
            return None
        if dim % _axsize(mesh, axes) == 0:
            return axes if len(axes) > 1 else axes[0]
        if "data" in axes and dim % _shape(mesh)["data"] == 0:
            return "data"
        return None
    if entry == MODEL_AXIS and MODEL_AXIS not in names:
        return None
    if entry not in names:
        return None
    return entry if dim % _axsize(mesh, entry) == 0 else None


def _check_dp_only(mesh) -> None:
    from repro_torch.sharding.tp import degree
    if degree(mesh) > 1:
        raise NotImplementedError(
            "activation hints on a mesh with a model axis: the port runs "
            "tensor parallelism by explicit operators (sharding/tp.py), "
            "not by hints")


def constrain(x, *entries):
    """Identity on a DP-only mesh (each rank holds its activations whole)
    and with no mesh; the entries are still checked against ``x``."""
    if _MESH is None or x is None:
        return x
    if len(entries) != x.dim():
        raise ValueError(f"{len(entries)} entries for a {x.dim()}-d tensor")
    _check_dp_only(_MESH)
    return x


_SEGMENT_SPECS = None


def set_segment_param_specs(specs) -> None:
    global _SEGMENT_SPECS
    _SEGMENT_SPECS = specs


def segment_param_specs():
    return _SEGMENT_SPECS


def constrain_spec(x, spec: Optional[tuple]):
    """Identity on a DP-only mesh, as :func:`constrain`."""
    if spec is None or _MESH is None:
        return x
    _check_dp_only(_MESH)
    return x
