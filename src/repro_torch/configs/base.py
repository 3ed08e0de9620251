"""Model configs and the architecture registry.

A copy of the parts of ``repro/configs/base.py`` that the port's
models read (attention, DeepSeek MLA and Mamba2 layers, dense and
Mixture-of-Experts FFNs, an encoder-decoder's encoder and a prefix of
input embeddings); the port keeps its own copy so that it imports nothing of
``repro``. Each architecture lives in its own
``configs/<id>.py`` file and registers a full-size :class:`ModelConfig`;
``smoke()`` derives the reduced variant the CPU tests use.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional, Tuple

ATTN = "attn"     # (sliding-window capable) GQA/MHA self-attention block
MLA = "mla"       # DeepSeek multi-head latent attention block
MAMBA = "mamba"   # Mamba2 SSD block


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    num_shared_experts: int = 0   # DeepSeek-style always-on shared experts
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


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
    d_ff: int                     # dense FFN hidden (0 if every layer is MoE/SSM)
    vocab_size: int
    # The network is ``num_layers / len(period)`` repetitions of ``period``.
    period: Tuple[str, ...] = (ATTN,)
    moe_period: Tuple[bool, ...] = (False,)   # which period slots are MoE FFNs
    first_k_dense: int = 0                    # leading layers forced dense FFN
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    head_dim: int = 0                         # 0 => d_model // num_heads
    qkv_bias: bool = False
    mlp_gated: bool = True                    # swiglu (3 mats) vs gelu (2 mats)
    rope_theta: float = 10000.0
    sliding_window: int = 0                   # 0 = full attention
    encoder_layers: int = 0                   # >0 => encoder-decoder
    input_mode: str = "tokens"                # tokens | embeddings | encdec
    num_prefix_embeddings: int = 0            # VLM patch / audio frame stub len
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    optimizer: str = "adamw"                  # adamw | adamw_bf16 | adafactor
    remat: str = "full"                       # none | full (per layer)
    microbatches: int = 1                     # gradient-accumulation steps
    mtp_depth: int = 0                        # DeepSeek multi-token prediction
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

    def layer_is_moe(self) -> Tuple[bool, ...]:
        """Per-layer MoE flag: ``moe_period`` repeated, the first
        ``first_k_dense`` layers forced dense."""
        reps = -(-self.num_layers // len(self.moe_period))
        flags = list((self.moe_period * reps)[: self.num_layers])
        for i in range(min(self.first_k_dense, self.num_layers)):
            flags[i] = False
        return tuple(flags)

    def segment_layers(self) -> Tuple[int, ...]:
        """The layer counts of the reference's segments, in order
        (``repro/models/transformer.py:35-45``): the ``first_k_dense``
        layers are a segment of their own, then the rest; the port keeps
        their layers in one list."""
        per = len(self.period)
        k = self.first_k_dense
        if k % per or (self.num_layers - k) % per:
            raise ValueError(f"{self.name}: segments of {k} and "
                             f"{self.num_layers - k} layers do not hold "
                             f"whole periods of {per}")
        return tuple(n for n in (k, self.num_layers - k) if n)

    def param_count(self) -> int:
        """Analytic parameter count (rooflines, 6ND; the simulator's phase
        flops and weight bytes) — ``repro/configs/base.py:124-172``, as it
        is: like the reference's, it leaves out an encoder-decoder's
        cross-attention blocks, their ``norm_x`` and the ``encoder_norm``
        (seamless_m4t_large_v2: 1,531,442,176 against a tree of
        1,632,131,072 leaves), so the simulator reads the reference's
        figures."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim()
        total = v * d  # embeddings
        if not self.tie_embeddings:
            total += v * d
        for kind, moe_l in zip(self.layer_kinds(), self.layer_is_moe()):
            total += 2 * d  # two norms
            if kind == ATTN:
                q = d * self.num_heads * hd
                kv = 2 * d * self.num_kv_heads * hd
                o = self.num_heads * hd * d
                total += q + kv + o
                if self.qkv_bias:
                    total += (self.num_heads + 2 * self.num_kv_heads) * hd
            elif kind == MLA:
                m = self.mla
                qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
                total += d * m.q_lora_rank + \
                    m.q_lora_rank * self.num_heads * qk_hd
                total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                total += m.kv_lora_rank * self.num_heads * \
                    (m.qk_nope_head_dim + m.v_head_dim)
                total += self.num_heads * m.v_head_dim * d
            elif kind == MAMBA:
                s = self.ssm
                di = s.d_inner(d)
                nh = s.n_heads(d)
                total += d * (2 * di + 2 * s.d_state * 0 + nh)  # in_proj(zx)+dt
                total += d * 2 * s.d_state * 2                  # B,C projections
                total += s.d_conv * (di + 2 * s.d_state)        # conv
                total += di * d                                 # out_proj
                total += 2 * nh                                 # A_log, D
            if moe_l and self.moe is not None:
                e = self.moe
                per = 3 * d * e.d_expert
                total += (e.num_experts + e.num_shared_experts) * per
                total += d * e.num_experts  # router
            elif kind != MAMBA:
                total += (3 if self.mlp_gated else 2) * d * self.d_ff
        # encoder stack (attention + dense FFN, full attention, no cache)
        for _ in range(self.encoder_layers):
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            total += q + kv + o + \
                (3 if self.mlp_gated else 2) * d * self.d_ff + 2 * d
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        dense_equiv = replace(
            self, moe=MoEConfig(
                num_experts=e.top_k, top_k=e.top_k, d_expert=e.d_expert,
                num_shared_experts=e.num_shared_experts))
        return dense_equiv.param_count()

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
            moe=MoEConfig(
                num_experts=4, top_k=2, d_expert=128,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                capacity_factor=8.0)   # drop-free: exact decode==forward
            if self.moe is not None else None,
            mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                          qk_nope_head_dim=32, qk_rope_head_dim=16,
                          v_head_dim=32) if self.mla is not None else None,
            first_k_dense=min(self.first_k_dense, 1),
            encoder_layers=2 if self.encoder_layers else 0,
            num_prefix_embeddings=8 if self.num_prefix_embeddings else 0,
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


def check_token_inputs(cfg: ModelConfig, what: str) -> None:
    """Refuse a config whose batches carry prefix or frame embeddings at
    an entry point that builds token batches only (the reference's fail
    there with a ``KeyError`` on the missing embeddings)."""
    if cfg.input_mode != "tokens":
        raise ValueError(f"{what} builds token-only batches; {cfg.name} "
                         f"takes input_mode {cfg.input_mode!r} (prefix or "
                         "frame embeddings beside the tokens)")


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
