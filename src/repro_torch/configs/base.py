"""Model configs and the architecture registry.

A copy of the parts of ``repro/configs/base.py`` that the port's
decoder reads (attention and Mamba2 layers); the port keeps its own copy
so that it imports nothing of ``repro``. Each architecture lives in its own
``configs/<id>.py`` file and registers a full-size :class:`ModelConfig`;
``smoke()`` derives the reduced variant the CPU tests use.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional, Tuple

ATTN = "attn"     # (sliding-window capable) GQA/MHA self-attention block
MAMBA = "mamba"   # Mamba2 SSD block


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD dims."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int                     # dense FFN hidden (0 if every layer is SSM)
    vocab_size: int
    period: Tuple[str, ...] = (ATTN,)
    ssm: Optional[SSMConfig] = None
    head_dim: int = 0                         # 0 => d_model // num_heads
    qkv_bias: bool = False
    mlp_gated: bool = True                    # swiglu (3 mats) vs gelu (2 mats)
    rope_theta: float = 10000.0
    sliding_window: int = 0                   # 0 = full attention
    input_mode: str = "tokens"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    optimizer: str = "adamw"                  # adamw only in the port
    remat: str = "full"                       # none | full (per layer)
    microbatches: int = 1                     # gradient-accumulation steps
    source: str = ""                          # citation bracket

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind for all num_layers."""
        reps = -(-self.num_layers // len(self.period))
        return tuple((self.period * reps)[: self.num_layers])

    def smoke(self) -> "ModelConfig":
        """Reduced same-family variant for CPU tests: the same widths as
        the JAX package's ``ModelConfig.smoke()`` for the fields kept here."""
        per = len(self.period)
        n_layers = per if per >= 2 else 2
        nh = min(self.num_heads, 4) or 0
        nkv = min(self.num_kv_heads, nh) or 0
        if self.num_heads and self.num_kv_heads:
            while nh % max(nkv, 1):     # keep GQA grouping valid
                nkv -= 1
        return replace(
            self,
            name=self.name + "-smoke",
            ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                          chunk_size=32) if self.ssm is not None else None,
            num_layers=n_layers,
            d_model=256,
            num_heads=nh,
            num_kv_heads=nkv,
            d_ff=512 if self.d_ff else 0,
            vocab_size=512,
            head_dim=64 if self.num_heads else 0,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
            remat="none",
            optimizer="adamw",
            microbatches=1,
            param_dtype="float32",
        )


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key not in _REGISTRY:
        try:
            importlib.import_module(f"repro_torch.configs.{key}")
        except ImportError as e:
            raise KeyError(f"unknown architecture {name!r}") from e
    return _REGISTRY[key]
