"""Model configs and the architecture registry.

A copy of the parts of ``repro/configs/base.py`` that the port's
attention-only decoder reads; the port keeps its own copy so that it
imports nothing of ``repro``. Each architecture lives in its own
``configs/<id>.py`` file and registers a full-size :class:`ModelConfig`;
``smoke()`` derives the reduced variant the CPU tests use.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Tuple

ATTN = "attn"     # (sliding-window capable) GQA/MHA self-attention block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                # query heads
    num_kv_heads: int
    d_ff: int                     # dense FFN hidden
    vocab_size: int
    period: Tuple[str, ...] = (ATTN,)
    head_dim: int = 0                         # 0 => d_model // num_heads
    qkv_bias: bool = False
    mlp_gated: bool = True                    # swiglu (3 mats) vs gelu (2 mats)
    rope_theta: float = 10000.0
    sliding_window: int = 0                   # 0 = full attention
    input_mode: str = "tokens"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    source: str = ""                          # citation bracket

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

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
            num_layers=n_layers,
            d_model=256,
            num_heads=nh,
            num_kv_heads=nkv,
            d_ff=512 if self.d_ff else 0,
            vocab_size=512,
            head_dim=64 if self.num_heads else 0,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
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
