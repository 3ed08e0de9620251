"""Decoder LM for token-input, attention-only configs — the port of
``repro/models/transformer.py`` (``Model``: init, embed/unembed, the layer
stack, forward, caches, prefill and one-token decode).

Where the reference scans stacked ``segment{i}/slot{j}`` parameters with
``jax.lax.scan``, the port keeps one parameter dict per layer in
``params["layers"]`` and runs a Python loop over them
(``repro_torch.bridge`` converts between the two layouts). Caches are one
dict per layer, updated in place.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch import default_device
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models import layers as L

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Model:
    """cfg-driven LM on ``device`` (``cuda`` unless one is given)."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.input_mode != "tokens" or any(k != ATTN for k in cfg.period):
            raise NotImplementedError(
                f"{cfg.name}: the port serves token-input, attention-only "
                "configs")
        if not cfg.d_ff:
            raise NotImplementedError(f"{cfg.name}: the port needs an FFN")
        self.cfg = cfg
        self.device = default_device(device)
        self.dtype = DTYPES[cfg.param_dtype]

    # ------------------------------------------------------------------ init
    def _init_layer(self, generator: torch.Generator) -> dict:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        return {
            "norm1": L.init_norm(cfg.d_model, dt, dev),
            "mixer": L.init_attention(generator, cfg, dt),
            "norm2": L.init_norm(cfg.d_model, dt, dev),
            "ffn": L.init_mlp(generator, cfg.d_model, cfg.d_ff,
                              cfg.mlp_gated, cfg.num_layers, dt),
        }

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
                "layers": [self._init_layer(generator)
                           for _ in range(cfg.num_layers)],
            }
            if not cfg.tie_embeddings:
                params["lm_head"] = L._init(
                    generator, (cfg.d_model, cfg.vocab_size), dtype=self.dtype)
        return params

    # ------------------------------------------------------------ embeddings
    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens]

    def unembed(self, params, h: torch.Tensor) -> torch.Tensor:
        h = L.rms_norm(h, params["final_norm"], self.cfg.norm_eps)
        w = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return h @ w

    # -------------------------------------------------------------- full seq
    def _slot_fwd(self, layer, h, positions, *, window,
                  init_cache: Optional[dict] = None):
        """One layer. With ``init_cache`` (prefill) it also fills the
        layer's decode cache in the same pass."""
        cfg = self.cfg
        x = L.rms_norm(h, layer["norm1"], cfg.norm_eps)
        y = L.attention_fwd(layer["mixer"], x, positions, cfg, window=window,
                            init_cache=init_cache)
        cache = None
        if init_cache is not None:
            y, cache = y
        h = h + y
        x2 = L.rms_norm(h, layer["norm2"], cfg.norm_eps)
        h = h + L.mlp_fwd(layer["ffn"], x2, cfg.mlp_gated)
        return h, cache

    def _stack_fwd(self, params, h, positions, *, window=0,
                   init_caches: Optional[List[dict]] = None):
        """Run every layer. Returns (h, filled caches or None)."""
        caches = []
        for i, layer in enumerate(params["layers"]):
            h, c = self._slot_fwd(
                layer, h, positions, window=window,
                init_cache=None if init_caches is None else init_caches[i])
            caches.append(c)
        return h, (caches if init_caches is not None else None)

    def _positions(self, tokens: torch.Tensor) -> torch.Tensor:
        B, S = tokens.shape
        return torch.arange(S, device=tokens.device).expand(B, S)

    @torch.no_grad()
    def forward(self, params, batch, *, window: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward -> (logits [B,S,V], h_final)."""
        tokens = batch["tokens"]
        h = self.embed(params, tokens)
        h, _ = self._stack_fwd(params, h, self._positions(tokens),
                               window=window)
        return self.unembed(params, h), h

    # ------------------------------------------------------------- kv caches
    def init_cache(self, batch: int, capacity: int, dtype) -> List[dict]:
        """One rolling decode cache per layer."""
        return [L.init_kv_cache(self.cfg, batch, capacity, dtype, self.device)
                for _ in range(self.cfg.num_layers)]

    @torch.no_grad()
    def prefill(self, params, batch, capacity: int, *, window: int = 0):
        """Process a prompt, returning (last-position logits [B,V], caches).
        caches = {"layers": [...]}: each holds the last ``min(S, capacity)``
        positions of a rolling buffer. Single pass."""
        tokens = batch["tokens"]
        h = self.embed(params, tokens)
        init_caches = self.init_cache(h.shape[0], capacity, h.dtype)
        h, filled = self._stack_fwd(params, h, self._positions(tokens),
                                    window=window, init_caches=init_caches)
        logits = self.unembed(params, h[:, -1:])[:, 0]
        return logits, {"layers": filled}

    @torch.no_grad()
    def decode_step(self, params, caches, token, position, *,
                    window: int = 0):
        """token [B] int, position [B] int32 -> (logits [B,V], caches);
        the caches are updated in place."""
        cfg = self.cfg
        h = self.embed(params, token[:, None])
        for layer, cache in zip(params["layers"], caches["layers"]):
            x = L.rms_norm(h, layer["norm1"], cfg.norm_eps)
            y, _ = L.attention_decode(layer["mixer"], x, position, cache, cfg,
                                      window=window)
            h = h + y
            x2 = L.rms_norm(h, layer["norm2"], cfg.norm_eps)
            h = h + L.mlp_fwd(layer["ffn"], x2, cfg.mlp_gated)
        return self.unembed(params, h)[:, 0], caches
