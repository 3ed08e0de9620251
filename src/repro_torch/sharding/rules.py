"""Parameter / batch / cache sharding rules — the port of
``repro/sharding/rules.py`` (``:41-435``), with no JAX.

Mesh axes: ``(data, model)``. ``data`` is the data-parallel (ZeRO) domain;
``model`` carries tensor parallelism. A spec is :class:`P`, a tuple with
one entry a tensor dim: ``None`` (whole on every rank), a mesh axis name,
or a tuple of names.

ZeRO stages (the reference's DESIGN.md §2):
  * stage 1/2 — parameters replicated over ``data`` (TP entries still
    apply), optimizer state sharded over it;
  * stage 3 — parameters sharded over ``data`` too.

Every rule checks divisibility and falls back to the next-best dim or to
replication, as the reference's does.

**Layout.** The reference stacks a segment's layers on a leading axis and
names a stacked leaf's spec with that axis stripped, then puts a leading
``None`` back. The port keeps one dict a layer (``params["layers"][i]``),
so a layer leaf's spec here is the reference's stacked spec without its
leading entry. One rule reads the stacked shape: :func:`zero_opt_pspecs`
takes "the largest unsharded dim that divides ndp", which on a stacked
leaf can be the layer axis itself (a ``[L, n]`` leaf with L > n). The
port has no layer axis to shard, so such leaves take their own largest
dim (ROADMAP §C lists them; ``tests/test_torch_sharding.py`` names them).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

from repro_torch.configs.base import ModelConfig

# The data-parallel domain's axis names (the reference also has "pod" for
# its multi-pod mesh) and the tensor-parallel axis.
DP_AXIS_NAMES = ("pod", "data")
MODEL_AXIS = "model"


class P(tuple):
    """A partition spec: one entry a tensor dim, each ``None``, a mesh axis
    name or a tuple of names (the port's ``jax.sharding.PartitionSpec``,
    which like it writes a one-name tuple as the name). Missing trailing
    entries mean ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def spec_map(fn: Callable, tree, *rest):
    """``fn`` over the specs of a spec tree (dicts and lists of :class:`P`)
    and the matching leaves of ``rest``; ``None`` stays ``None``."""
    if isinstance(tree, P):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: spec_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [spec_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(tree, *rest)


def spec_leaves(tree):
    """The specs of a spec tree in dict-insertion and list order."""
    if isinstance(tree, P):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from spec_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from spec_leaves(v)


def _map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree of tensors; ``path`` holds the dict
    keys and list indices (as strings) from the root."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(path, tree)


def dp_axes(mesh):
    return tuple(a for a in DP_AXIS_NAMES if a in mesh.axis_names)


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


class SpecMesh:
    """Devices-free mesh for spec construction and byte accounting: the
    rules read only ``mesh.shape`` (a name -> size mapping) and
    ``mesh.axis_names``. ``ShardedContext`` builds its specs on one of
    these beside its ``DeviceMesh``; the simulator builds them for any
    ndp without a process group."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)

    def __repr__(self) -> str:
        return f"SpecMesh({self.shape})"


@dataclass(frozen=True)
class ShardingStrategy:
    """The paper's §2.2 memory-management strategy knobs."""
    zero_stage: int = 3          # 0 | 1 | 2 | 3  (0 = fully replicated DP)
    tensor_parallel: bool = True
    expert_parallel: bool = True
    # the size the "model" axis must have when this strategy runs (1 =
    # no TP); a strategy with ntp > 1 refuses meshes that disagree
    ntp: int = 1
    # TP layout recipe: "megatron" (column/row-parallel) is the only one
    tp_mode: str = "megatron"
    # ZeRO-3 gather granularity: "layer" gathers one layer just before it
    # runs and frees it after (the transient is one layer), "tree" the
    # whole tree before the forward (the transient is the replicated
    # model). Both give the same bits. Ignored below stage 3.
    gather_mode: str = "layer"   # "layer" | "tree"
    # host-offloaded optimizer state (the simulator's cpu_offload axis)
    offload_optimizer: bool = False
    remat: Optional[str] = None       # override cfg.remat if set

    def __post_init__(self):
        if self.ntp < 1:
            raise ValueError(f"ntp must be >= 1, got {self.ntp}")
        if self.tp_mode != "megatron":
            raise ValueError(f"unknown tp_mode {self.tp_mode!r} "
                             "(supported: 'megatron')")
        if self.ntp > 1 and not self.tensor_parallel:
            raise ValueError("ntp > 1 requires tensor_parallel=True")


# Megatron site classification for the LoRA adapter rules: column-parallel
# base products shard their output dim over "model", row-parallel ones
# their input dim (the per-name entries of param_pspecs).
TP_COL_SITES = ("wq", "wk", "wv", "w_in", "w_gate", "in_proj",
                "q_up", "kv_up", "proj")
TP_ROW_SITES = ("wo", "w_out", "out_proj")


def validate_tp(cfg: ModelConfig, ntp: int) -> None:
    """Reject a (config, TP degree) pair the Megatron layout cannot shard:
    heads, FFN width and vocab must all divide ``ntp``."""
    if ntp <= 1:
        return
    bad = []
    if cfg.num_heads % ntp:
        bad.append(f"num_heads={cfg.num_heads}")
    if cfg.d_ff and cfg.d_ff % ntp:
        bad.append(f"d_ff={cfg.d_ff}")
    if cfg.vocab_size % ntp:
        bad.append(f"vocab_size={cfg.vocab_size}")
    if bad:
        raise ValueError(
            f"config {cfg.name!r} cannot run tensor-parallel at ntp={ntp}: "
            f"{', '.join(bad)} must be divisible by ntp. Pick a TP degree "
            f"dividing all of (num_heads, d_ff, vocab_size) or adjust the "
            f"config.")


def _check_tp_mesh(mesh, strat: ShardingStrategy) -> None:
    if strat.ntp > 1:
        size = dict(mesh.shape).get("model")
        if size != strat.ntp:
            raise ValueError(
                f"strategy declares ntp={strat.ntp} but the mesh's 'model' "
                f"axis is {size} ({tuple(mesh.axis_names)})")


def _div(mesh, dim: int, axes) -> bool:
    return dim % _axsize(mesh, axes) == 0 and _axsize(mesh, axes) > 1


def param_pspecs(cfg: ModelConfig, mesh, strat: ShardingStrategy,
                 params_shape) -> dict:
    """Spec tree matching ``params_shape`` (the port's parameter tree; its
    leaves' shapes are read, so ``meta`` tensors do)."""
    _check_tp_mesh(mesh, strat)
    dp = dp_axes(mesh)
    mp = "model" if (strat.tensor_parallel and "model" in mesh.axis_names) \
        else None
    fsdp = dp if strat.zero_stage >= 3 else None

    def fs(dim: int):
        return fsdp if (fsdp and dim % _axsize(mesh, fsdp) == 0) else None

    def tp(dim: int):
        return mp if (mp and dim % _axsize(mesh, mp) == 0) else None

    def spec_for(path: Tuple[str, ...], leaf) -> P:
        shape = tuple(leaf.shape)
        name = path[-1]
        parent = path[-2] if len(path) >= 2 else ""
        mk = P

        if name == "embed":
            return mk(tp(shape[0]), fs(shape[1]))
        if name == "lm_head":
            return mk(fs(shape[0]), tp(shape[1]))
        if name in ("final_norm", "encoder_norm", "norm1", "norm2", "norm_x",
                    "q_norm", "kv_norm", "norm_h", "norm_e"):
            return mk(*([None] * len(shape)))
        if name == "scale":
            return mk(*([None] * len(shape)))
        # attention -----------------------------------------------------
        if name in ("wq", "wk", "wv"):
            return mk(fs(shape[0]), tp(shape[1]))
        if name == "wo":
            return mk(tp(shape[0]), fs(shape[1]))
        if name in ("bq", "bk", "bv"):
            return mk(tp(shape[0]))
        # MLA -----------------------------------------------------------
        if name in ("q_down", "kv_down"):
            return mk(fs(shape[0]), None)
        if name in ("q_up", "kv_up"):
            return mk(fs(shape[0]), tp(shape[1]))
        # MLP -----------------------------------------------------------
        if name in ("w_in", "w_gate") and len(shape) == 2:
            return mk(fs(shape[0]), tp(shape[1]))
        if name == "w_out" and len(shape) == 2:
            return mk(tp(shape[0]), fs(shape[1]))
        # MoE experts [E, D, F] / [E, F, D] -------------------------------
        if name in ("w_in", "w_gate") and len(shape) == 3:
            ep = mp if (strat.expert_parallel and mp
                        and _div(mesh, shape[0], mp)) else None
            if ep:
                return mk(ep, fs(shape[1]), None)
            return mk(None, fs(shape[1]), tp(shape[2]))
        if name == "w_out" and len(shape) == 3:
            ep = mp if (strat.expert_parallel and mp
                        and _div(mesh, shape[0], mp)) else None
            if ep:
                return mk(ep, None, fs(shape[2]))
            return mk(None, tp(shape[1]), fs(shape[2]))
        if name == "router":
            return mk(fs(shape[0]), None)
        # Mamba ----------------------------------------------------------
        if name == "in_proj":
            return mk(fs(shape[0]), tp(shape[1]))
        if name == "out_proj":
            return mk(tp(shape[0]), fs(shape[1]))
        if name in ("conv_w", "conv_b"):
            return mk(*([None] * (len(shape) - 1)), tp(shape[-1]))
        if name in ("dt_bias", "A_log", "D", "norm"):
            return mk(*([None] * len(shape)))
        # heads / misc -----------------------------------------------------
        if parent == "value_head" or name in ("w", "b"):
            return mk(*([None] * len(shape)))
        if name == "proj":  # mtp projection [2D, D]
            return mk(fs(shape[0]), tp(shape[1]))
        return mk(*([None] * len(shape)))

    return _map_with_path(spec_for, params_shape)


def zero_opt_pspecs(param_specs, params_shape, mesh, strat: ShardingStrategy):
    """ZeRO-1/2: optimizer state sharded over the DP domain even where the
    parameters are replicated there: each leaf shards the largest dim that
    is unsharded in its param spec and divides the DP size. At ZeRO-3 the
    state mirrors the (already DP-sharded) param spec."""
    dp = dp_axes(mesh)
    n = _axsize(mesh, dp)

    def respec(spec: P, leaf) -> P:
        if strat.zero_stage >= 3 or strat.zero_stage < 1 or n == 1:
            return spec
        shape = tuple(leaf.shape)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        best, best_dim = None, 0
        for i, (e, d) in enumerate(zip(entries, shape)):
            if e is None and d % n == 0 and d > best_dim:
                best, best_dim = i, d
        if best is not None:
            entries[best] = dp if len(dp) > 1 else dp[0]
        return P(*entries)

    return spec_map(respec, param_specs, params_shape)


def adapter_pspecs(mesh, strat: ShardingStrategy, adapter_shape) -> dict:
    """Spec tree for a hydra LoRA adapter (``models.lora.init_adapter``:
    {"lora": {... {"a", "b"} sites}, optional "value_head"}):

      * ``a`` factors ``[d_in, r]`` shard ``d_in`` over the DP domain at
        ZeRO-3 (the rank dim stays whole);
      * ``b`` factors ``[r, d_out]`` shard ``d_out`` likewise;
      * value heads and biases are whole;
      * below ZeRO-3 the DP entries drop.

    Under TP each factor partitions with its base product: column sites
    put "model" on ``b``'s ``d_out``, row sites on ``a``'s ``d_in``; a dim
    takes the TP entry or the DP one, TP first."""
    _check_tp_mesh(mesh, strat)
    dp = dp_axes(mesh)
    fsdp = dp if strat.zero_stage >= 3 else None
    mp = "model" if (strat.tensor_parallel and "model" in mesh.axis_names) \
        else None

    def fs(dim: int):
        return fsdp if (fsdp and dim % _axsize(mesh, fsdp) == 0) else None

    def tp(dim: int):
        return mp if (mp and dim % _axsize(mesh, mp) == 0) else None

    def spec_for(path: Tuple[str, ...], leaf) -> P:
        shape = tuple(leaf.shape)
        name = path[-1]
        site = path[-2] if len(path) >= 2 else ""
        if "value_head" in path or len(shape) < 2:
            return P(*([None] * len(shape)))
        lead = (None,) * (len(shape) - 2)
        row_par = site in TP_ROW_SITES
        if name == "a":
            e = (tp(shape[-2]) or fs(shape[-2])) if row_par \
                else fs(shape[-2])
            return P(*lead, e, None)
        if name == "b":
            e = fs(shape[-1]) if row_par \
                else (tp(shape[-1]) or fs(shape[-1]))
            return P(*lead, None, e)
        return P(*([None] * len(shape)))

    return _map_with_path(spec_for, adapter_shape)


def spec_device_fraction(spec: P, leaf, mesh) -> float:
    """Per-rank fraction of ``leaf``'s bytes under ``spec``: 1/(product of
    the mesh axes the spec uses)."""
    n = 1
    for entry in spec:
        if entry is not None:
            n *= _axsize(mesh, entry)
    return 1.0 / n


# ---------------------------------------------------------------------------
# Batches / caches
# ---------------------------------------------------------------------------
def batch_pspecs(cfg: ModelConfig, shape, mesh) -> dict:
    """Specs of a step's input batch; ``shape`` has ``global_batch`` and
    ``kind`` ("train" adds the PPO fields). The batch dim shards over the
    DP domain where it divides."""
    dp = dp_axes(mesh)
    B = shape.global_batch
    bspec: Any = dp if B % _axsize(mesh, dp) == 0 else None
    if isinstance(bspec, tuple) and len(bspec) == 1:
        bspec = bspec[0]
    tok2 = P(bspec, None)
    specs = {"tokens": tok2}
    if shape.kind == "train":
        specs.update({"loss_mask": tok2, "advantages": tok2,
                      "old_logp": tok2, "ref_logp": tok2, "returns": tok2})
    if cfg.input_mode == "embeddings":
        specs["prefix_embeds"] = P(bspec, None, None)
    if cfg.input_mode == "encdec":
        specs["frame_embeds"] = P(bspec, None, None)
    return specs


def cache_pspecs(model, cfg: ModelConfig, mesh, batch: int,
                 strat: ShardingStrategy, cache_shapes) -> list:
    """Decode-cache specs over the port's per-layer caches (the reference's
    stacked ones less their leading group entry). Batch shards over DP
    when it divides; otherwise an attention cache shards its capacity dim
    (sequence-parallel KV)."""
    dp = dp_axes(mesh)
    ndp = _axsize(mesh, dp)
    dpa = dp if len(dp) > 1 else dp[0]
    mp = "model" if (strat.tensor_parallel and "model" in mesh.axis_names) \
        else None
    batch_ok = batch % ndp == 0 and ndp > 1

    def spec_for(path, leaf) -> P:
        shape = tuple(leaf.shape)
        name = path[-1]
        b = dpa if batch_ok else None

        def dim_ax(i, ax):
            if not ax:
                return None
            axes = ax if isinstance(ax, tuple) else (ax,)
            return ax if shape[i] % _axsize(mesh, axes) == 0 else None

        if name in ("k", "v"):          # [B, cap, K, hd]
            seq = None if batch_ok else dim_ax(1, dpa)
            kh = dim_ax(2, mp)
            hd = dim_ax(3, mp) if kh is None else None   # kv<TP: head_dim
            return P(b, seq, kh, hd)
        if name in ("c_kv", "k_rope"):  # [B, cap, r]
            seq = None if batch_ok else dim_ax(1, dpa)
            return P(b, seq, dim_ax(2, mp))
        if name == "pos":               # [B, cap]
            seq = None if batch_ok else dim_ax(1, dpa)
            return P(b, seq)
        if name == "conv_state":        # [B, W-1, C]
            return P(b, None, dim_ax(2, mp))
        if name == "ssm_state":         # [B, H, P, N]
            return P(b, dim_ax(1, mp), None, None)
        return P(*([None] * len(shape)))

    return _map_with_path(spec_for, cache_shapes)
