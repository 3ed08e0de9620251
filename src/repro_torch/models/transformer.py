"""Decoder LM for token-input configs of attention and Mamba2 layers — the
port of ``repro/models/transformer.py`` (``Model``: init, embed/unembed,
the layer stack, forward, caches, prefill and one-token decode, and the
paged prefill and decode over per-layer page pools), and the training
forward: LoRA adapters applied unmerged (``forward(adapter=)``), the value
head of ``forward_value`` (the adapter's, or the model's own with
``with_value=True``: the separate engine's critic and reward), merge/unmerge
for rollout, and remat as one ``torch.utils.checkpoint`` per layer under
the policy of ``offload.policies`` ("full", "dots", "offload").

Where the reference scans stacked ``segment{i}/slot{j}`` parameters with
``jax.lax.scan``, the port keeps one parameter dict per layer in
``params["layers"]`` and runs a Python loop over them
(``repro_torch.bridge`` converts between the two layouts). Caches and
paged pools are one dict per layer, updated in place: a rolling KV cache
for an attention layer, the conv and SSM states for a Mamba layer.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import default_device
from repro_torch.configs.base import ATTN, MAMBA, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import lora as LORA
from repro_torch.models import mamba as M
from repro_torch.offload.policies import REMATS, remat_policy_for
from repro_torch.paged import attention as PA
from repro_torch.paged import paged_cache as PC

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Model:
    """cfg-driven LM on ``device`` (``cuda`` unless one is given).
    ``with_value=True`` adds a scalar value head (the critic and reward
    models of the separate engine share this class)."""

    def __init__(self, cfg: ModelConfig, device=None, *,
                 with_value: bool = False):
        if cfg.input_mode != "tokens" or \
                any(k not in (ATTN, MAMBA) for k in cfg.period):
            raise NotImplementedError(
                f"{cfg.name}: the port serves token-input configs of "
                "attention and Mamba2 layers")
        if MAMBA in cfg.period and cfg.ssm is None:
            raise ValueError(f"{cfg.name}: a Mamba layer needs cfg.ssm")
        if cfg.remat not in REMATS:
            raise ValueError(f"remat={cfg.remat!r}: expected one of {REMATS}")
        self.cfg = cfg
        self.with_value = with_value
        self.kinds = cfg.layer_kinds()
        self.device = default_device(device)
        self.dtype = DTYPES[cfg.param_dtype]

    # ------------------------------------------------------------------ init
    def _init_layer(self, generator: torch.Generator, kind: str) -> dict:
        """One layer's parameters; ``norm2`` and ``ffn`` only when the
        config has an FFN (``d_ff > 0``), as in the reference."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        layer = {"norm1": L.init_norm(cfg.d_model, dt, dev)}
        if kind == ATTN:
            layer["mixer"] = L.init_attention(generator, cfg, dt)
        else:
            layer["mixer"] = M.init_mamba(generator, cfg, dt)
        if cfg.d_ff:
            layer["norm2"] = L.init_norm(cfg.d_model, dt, dev)
            layer["ffn"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                      cfg.mlp_gated, cfg.num_layers, dt)
        return layer

    def init(self, generator: torch.Generator) -> dict:
        """Random weights from ``generator`` (which lives on the model's
        device). The reference's init draws from ``jax.random``, so the two
        packages' random weights differ; ``bridge.from_jax`` carries the
        reference's weights across instead."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        with torch.no_grad():
            params = {
                "embed": L._init(generator, (cfg.vocab_size, cfg.d_model),
                                 dtype=self.dtype),
                "final_norm": L.init_norm(cfg.d_model, self.dtype,
                                          self.device),
                "layers": [self._init_layer(generator, kind)
                           for kind in self.kinds],
            }
            if not cfg.tie_embeddings:
                params["lm_head"] = L._init(
                    generator, (cfg.d_model, cfg.vocab_size), dtype=self.dtype)
            if self.with_value:
                params["value_head"] = {
                    "w": L._init(generator, (cfg.d_model, 1)),
                    "b": torch.zeros((1,), dtype=torch.float32,
                                     device=self.device)}
        return params

    # -------------------------------------------------------- lora adapters
    def init_adapter(self, generator: torch.Generator, params, rank: int, *,
                     with_value: bool = False) -> dict:
        """Per-role LoRA adapter over ``params`` (``models/lora.py``)."""
        return LORA.init_adapter(generator, params, rank,
                                 with_value=with_value,
                                 d_model=self.cfg.d_model)

    def merge_adapter(self, params, adapter) -> dict:
        """Fold A·B into the base weights (rollout-speed generation); the
        result aliases the base at non-adapted leaves."""
        return LORA.merge_adapter(params, (adapter or {}).get("lora"))

    def unmerge_adapter(self, params, adapter) -> dict:
        """Subtract A·B back out of a merged tree (fp round-off applies)."""
        return LORA.unmerge_adapter(params, (adapter or {}).get("lora"))

    # ------------------------------------------------------------ embeddings
    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens]

    def unembed(self, params, h: torch.Tensor) -> torch.Tensor:
        h = L.rms_norm(h, params["final_norm"], self.cfg.norm_eps)
        w = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return h @ w

    # -------------------------------------------------------------- full seq
    def _slot_fwd(self, layer, kind, h, positions, *, window,
                  init_cache: Optional[dict] = None, adapter=None):
        """One layer. With ``init_cache`` (prefill) it also fills the
        layer's decode cache in the same pass: an attention layer's
        rolling KV cache, or a Mamba layer's conv and SSM states (copied
        into the cache's buffers). ``adapter`` is the layer's LoRA subtree
        (unmerged A·B at the attention and MLP sites)."""
        cfg = self.cfg
        ad = adapter or {}
        x = L.rms_norm(h, layer["norm1"], cfg.norm_eps)
        cache = None
        if kind == ATTN:
            y = L.attention_fwd(layer["mixer"], x, positions, cfg,
                                window=window, init_cache=init_cache,
                                adapter=ad.get("mixer"))
            if init_cache is not None:
                y, cache = y
        elif init_cache is not None:
            y, state = M.mamba_fwd(layer["mixer"], x, cfg, return_state=True)
            for name, val in state.items():
                init_cache[name].copy_(val)
            cache = init_cache
        else:
            y = M.mamba_fwd(layer["mixer"], x, cfg)
        h = h + y
        if "ffn" in layer:
            x2 = L.rms_norm(h, layer["norm2"], cfg.norm_eps)
            h = h + L.mlp_fwd(layer["ffn"], x2, cfg.mlp_gated,
                              adapter=ad.get("ffn"))
        return h, cache

    def _stack_fwd(self, params, h, positions, *, window=0,
                   init_caches: Optional[List[dict]] = None, adapter=None):
        """Run every layer. Returns (h, filled caches or None).
        ``adapter`` is a LoRA adapter over ``params``. With ``cfg.remat``
        other than "none" and grad mode on, each layer is one activation
        checkpoint (non-reentrant) under ``remat_policy_for(cfg.remat)``:
        its forward runs again in the backward, kernels included (the
        reference's ``jax.checkpoint`` per scanned layer group). "offload"
        moves only what the checkpoint saves, the layer's input, to host:
        the logits and the loss's residuals stay."""
        lora = (adapter or {}).get("lora") or {}
        ads = lora.get("layers") or [None] * len(self.kinds)
        remat = self.cfg.remat != "none" and torch.is_grad_enabled() and \
            init_caches is None
        if remat:
            ckpt_kw, around = remat_policy_for(self.cfg.remat)
        caches = []
        for i, (kind, layer) in enumerate(zip(self.kinds, params["layers"])):
            if remat:
                with around():
                    h = checkpoint(
                        lambda hh, layer=layer, kind=kind, ad=ads[i]:
                        self._slot_fwd(layer, kind, hh, positions,
                                       window=window, adapter=ad)[0],
                        h, use_reentrant=False, **ckpt_kw)
                caches.append(None)
                continue
            h, c = self._slot_fwd(
                layer, kind, h, positions, window=window,
                init_cache=None if init_caches is None else init_caches[i],
                adapter=ads[i])
            caches.append(c)
        return h, (caches if init_caches is not None else None)

    def _positions(self, tokens: torch.Tensor) -> torch.Tensor:
        B, S = tokens.shape
        return torch.arange(S, device=tokens.device).expand(B, S)

    def forward(self, params, batch, *, window: int = 0, adapter=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward -> (logits [B,S,V], h_final). ``adapter``
        (a LoRA adapter) is applied unmerged. The caller picks the grad
        mode: training differentiates through it, scoring runs it under
        ``torch.no_grad()``."""
        tokens = batch["tokens"]
        h = self.embed(params, tokens)
        h, _ = self._stack_fwd(params, h, self._positions(tokens),
                               window=window, adapter=adapter)
        return self.unembed(params, h), h

    def forward_value(self, params, batch, adapter=None) -> torch.Tensor:
        """[B,S] per-token fp32 values (critic / reward): the trunk with
        ``adapter``, the final norm, then the adapter's value head (the
        hydra engine's critic and reward share a headless trunk), or
        without one the model's own ``params["value_head"]``."""
        tokens = batch["tokens"]
        h = self.embed(params, tokens)
        h, _ = self._stack_fwd(params, h, self._positions(tokens),
                               adapter=adapter)
        h = L.rms_norm(h, params["final_norm"], self.cfg.norm_eps)
        vh = (adapter or {}).get("value_head") or params["value_head"]
        return (h.float() @ vh["w"] + vh["b"])[..., 0]

    # ------------------------------------------------------------- kv caches
    def init_cache(self, batch: int, capacity: int, dtype) -> List[dict]:
        """One decode cache per layer: a rolling KV cache of ``capacity``
        slots for an attention layer; the conv and SSM states for a Mamba
        layer, whose size ``capacity`` does not touch."""
        return [L.init_kv_cache(self.cfg, batch, capacity, dtype, self.device)
                if kind == ATTN else
                M.init_mamba_cache(self.cfg, batch, dtype, self.device)
                for kind in self.kinds]

    @torch.no_grad()
    def prefill(self, params, batch, capacity: int, *, window: int = 0,
                lengths: Optional[torch.Tensor] = None,
                return_h: bool = False):
        """Process a prompt, returning (last-position logits [B,V], caches).
        caches = {"layers": [...]}: each holds the last ``min(S, capacity)``
        positions of a rolling buffer. Single pass.

        ``lengths`` [B] (optional) marks per-row valid-token counts under
        right-padding: logits come from position ``lengths-1`` and padded
        cache entries are invalidated (their "pos" set to -1), exact
        because causal attention makes right-padding invisible to earlier
        positions. Attention layers only: a Mamba state cannot be masked
        after the fact, so a Mamba model raises on ``lengths``.
        ``return_h=True`` also returns the pre-final-norm hidden state at
        the logits position [B, D]."""
        h_last, filled = self._prefill_h(params, batch, capacity, window,
                                         lengths)
        logits = self.unembed(params, h_last[:, None])[:, 0]
        if return_h:
            return logits, {"layers": filled}, h_last
        return logits, {"layers": filled}

    def _prefill_h(self, params, batch, capacity, window, lengths):
        """The prefill's trunk: (hidden state at each row's last valid
        position [B, D], filled caches)."""
        if lengths is not None and MAMBA in self.kinds:
            raise ValueError(f"{self.cfg.name}: a lengths-masked prefill "
                             "cannot mask Mamba states after the fact")
        tokens = batch["tokens"]
        h = self.embed(params, tokens)
        B = h.shape[0]
        init_caches = self.init_cache(B, capacity, h.dtype)
        h, filled = self._stack_fwd(params, h, self._positions(tokens),
                                    window=window, init_caches=init_caches)
        if lengths is None:
            return h[:, -1], filled
        idx = torch.clamp(lengths - 1, min=0).long()
        for c in filled:
            c["pos"].masked_fill_(c["pos"] >= lengths[:, None], -1)
        return h[torch.arange(B, device=h.device), idx], filled

    def _decode(self, params, token, mix) -> torch.Tensor:
        """One-token pass over every layer; ``mix(i, mixer, x)`` steps layer
        i's mixer on its cache (dense or paged KV, or Mamba states).
        -> logits [B,V]."""
        cfg = self.cfg
        h = self.embed(params, token[:, None])
        for i, layer in enumerate(params["layers"]):
            x = L.rms_norm(h, layer["norm1"], cfg.norm_eps)
            h = h + mix(i, layer["mixer"], x)
            if "ffn" in layer:
                x2 = L.rms_norm(h, layer["norm2"], cfg.norm_eps)
                h = h + L.mlp_fwd(layer["ffn"], x2, cfg.mlp_gated)
        return self.unembed(params, h)[:, 0]

    @torch.no_grad()
    def decode_step(self, params, caches, token, position, *,
                    window: int = 0):
        """token [B] int, position [B] int32 -> (logits [B,V], caches);
        the caches are updated in place. A Mamba layer ignores
        ``position``."""
        layers = caches["layers"]

        def mix(i, mixer, x):
            if self.kinds[i] == ATTN:
                return L.attention_decode(mixer, x, position, layers[i],
                                          self.cfg, window=window)[0]
            return M.mamba_decode(mixer, x, layers[i], self.cfg)[0]

        return self._decode(params, token, mix), caches

    # ------------------------------------------------------- paged kv caches
    def supports_paged(self) -> bool:
        """The paged backend covers token-input, attention-only nets; Mamba
        states are not paged."""
        return self.cfg.input_mode == "tokens" and \
            all(k == ATTN for k in self.kinds)

    def init_paged_pools(self, num_pages: int, page_size: int,
                         dtype) -> List[dict]:
        """One paged KV pool per layer (``paged_cache.init_pool``). The
        block table is shared across layers; each layer owns its pool."""
        if not self.supports_paged():
            raise ValueError(f"{self.cfg.name}: paged pools need an "
                             "attention-only token model")
        return [PC.init_pool(self.cfg, num_pages, page_size, dtype,
                             self.device)
                for _ in range(self.cfg.num_layers)]

    @torch.no_grad()
    def paged_prefill(self, params, batch, pools, block_tables, lengths, *,
                      return_h: bool = False):
        """Prefill into paged pools: the dense single-pass prompt compute
        (capacity S, through the flash kernel), then each layer's K/V
        scattered to the sequences' pages, in place. batch["tokens"]
        [B, S]; block_tables [B, nb] int32; lengths [B] valid-token counts
        — logits come from position ``lengths-1``. Returns
        (last-valid-position logits [B, V], pools[, h_last])."""
        S = batch["tokens"].shape[1]
        h_last, filled = self._prefill_h(params, batch, S, 0, lengths)
        for pool, c in zip(pools, filled):
            PC.scatter_prefill(pool, c["k"], c["v"], block_tables, lengths)
        filled.clear()                # the dense prefill cache was transient
        logits = self.unembed(params, h_last[:, None])[:, 0]
        if return_h:
            return logits, pools, h_last
        return logits, pools

    @torch.no_grad()
    def paged_decode_step(self, params, pools, token, position,
                          block_tables):
        """One-token decode over paged pools. token/position [B] (position
        is the logical index being written); block_tables [B, nb]. The
        pools are updated in place. Returns (logits [B, V], pools)."""
        logits = self._decode(params, token, lambda i, mixer, x:
                              PA.paged_attention_decode(
                                  mixer, x, position, pools[i],
                                  block_tables, self.cfg)[0])
        return logits, pools
