"""Decoder LM of attention, DeepSeek MLA and Mamba2 layers with dense or
Mixture-of-Experts FFNs (``models/moe.py``), over token inputs, prefix
embeddings before the tokens (a VLM's patch stub) or an encoder's frame
embeddings (an encoder-decoder) — the port of
``repro/models/transformer.py`` (``Model``: init, embed/unembed,
the layer stack, forward, caches, prefill and one-token decode, and the
paged prefill and decode over per-layer page pools), DeepSeek's chained
multi-token-prediction (MTP) heads with the self-speculative decode they
draft for (``mtp_chain_logits``, ``mtp_draft``, the T-token verify
forwards ``decode_multi`` and ``paged_decode_multi``, and the paged
suffix prefill over a cached prefix), and the training
forward: LoRA adapters applied unmerged (``forward(adapter=)``, and
``adapter=`` on every cache path: prefill, decode, paged and verify), the
value head of ``forward_value`` (the adapter's, or the model's own with
``with_value=True``: the separate engine's critic and reward), merge/unmerge
for rollout, and remat as one ``torch.utils.checkpoint`` per layer under
the policy of ``offload.policies`` ("full", "dots", "offload").

Where the reference scans stacked ``segment{i}/slot{j}`` parameters with
``jax.lax.scan``, the port keeps one parameter dict per layer in
``params["layers"]`` and runs a Python loop over them; the MTP modules
are a list too, ``params["mtp"]`` (depth 1 first), where the reference
keeps depth 1 in ``params["mtp"]`` and stacks depths 2..k on
``params["mtp_extra"]``'s lead axis (``repro_torch.bridge`` converts
between the two layouts). The reference's segments (DeepSeek's
``first_k_dense`` layers are a leading segment of their own) are one list
here, in layer order. Caches and
paged pools are one dict per layer, updated in place: a rolling KV cache
for an attention layer, the latent and rope key for an MLA layer, the
conv and SSM states for a Mamba layer (a hybrid such as Jamba holds both
kinds in one list). MLA and Mamba layers are neither paged nor verified
by speculative decoding, as in the reference.

Inputs (``_prepare_inputs``, as the reference's): ``input_mode``
"tokens" embeds ``batch["tokens"]``; "embeddings" puts
``batch["prefix_embeds"]`` [B, P, D] before the token embeddings, the
positions running over both, so the caches hold the prefix and a decode
step's position counts its P slots; "encdec" runs the bidirectional
encoder over ``batch["frame_embeds"]`` [B, Se, D] (``params["encoder"]``,
a list of attention + ungated-FFN layers with RoPE over 0..Se-1, B2
non-causal, then ``encoder_norm``) and gives every decoder layer a
cross-attention (``norm_x``, ``cross``, between its mixer and its FFN)
over its own K/V of the encoder's output. Those are computed once a
forward or a prefill; a prefill keeps them in ``caches["cross_kv"]`` (one
dict a layer, ``layers.encode_cross_kv``), which every decode step reads
in place through B2 at one query a row. Neither mode is paged, speculatively decoded or
prefilled under ``lengths``, as in the reference.

A layer's FFN is MoE where ``cfg.layer_is_moe()`` says so and dense
where ``cfg.d_ff`` (a Mamba layer carries one too, as the reference's
``_seg_has_ffn``); an MoE FFN is told by its ``router`` leaf. The full
forward sums the MoE layers' load-balance losses (``forward`` returns
``(logits, aux, h)``, as the reference); the cache paths run the same
MoE FFNs and drop the loss.

Under an ambient tensor-parallel group (``sharding.ctx.use_mesh`` on a
mesh whose ``model`` axis is above 1; ``sharding/tp.py``) the params are
the rank's Megatron cuts: the embedding is vocab-parallel (a masked
lookup of the rank's rows, summed over the ranks), and every logits the
model returns are the rank's ``V/ntp`` columns (the losses take their
log-probs from them, a sampler gathers the rows it draws from); the
layers run at the rank's head counts (``models/layers.py``).
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import default_device
from repro_torch.configs.base import ATTN, MAMBA, MLA, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import lora as LORA
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.offload.policies import REMATS, remat_policy_for
from repro_torch.paged import attention as PA
from repro_torch.paged import paged_cache as PC
from repro_torch.sharding import ctx
from repro_torch.sharding import tp as TP

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
INPUT_MODES = ("tokens", "embeddings", "encdec")


class Model:
    """cfg-driven LM on ``device`` (``cuda`` unless one is given).
    ``with_value=True`` adds a scalar value head (the critic and reward
    models of the separate engine share this class)."""

    def __init__(self, cfg: ModelConfig, device=None, *,
                 with_value: bool = False):
        if any(k not in (ATTN, MLA, MAMBA) for k in cfg.period):
            raise ValueError(f"{cfg.name}: unknown layer kinds {cfg.period}")
        if cfg.input_mode not in INPUT_MODES:
            raise ValueError(f"{cfg.name}: input_mode {cfg.input_mode!r}, "
                             f"expected one of {INPUT_MODES}")
        if (cfg.input_mode == "encdec") != (cfg.encoder_layers > 0):
            raise ValueError(f"{cfg.name}: an encoder-decoder has encoder "
                             "layers, and only it")
        if MAMBA in cfg.period and cfg.ssm is None:
            raise ValueError(f"{cfg.name}: a Mamba layer needs cfg.ssm")
        if MLA in cfg.period and cfg.mla is None:
            raise ValueError(f"{cfg.name}: an MLA layer needs cfg.mla")
        if cfg.remat not in REMATS:
            raise ValueError(f"remat={cfg.remat!r}: expected one of {REMATS}")
        self.cfg = cfg
        self.with_value = with_value
        self.kinds = cfg.layer_kinds()
        self.moe_flags = tuple(m and cfg.moe is not None
                               for m in cfg.layer_is_moe())
        self.device = default_device(device)
        self.dtype = DTYPES[cfg.param_dtype]
        self.is_encdec = cfg.input_mode == "encdec"

    # ------------------------------------------------------------------ init
    def _init_layer(self, generator: torch.Generator, kind: str,
                    is_moe: bool, cross: bool = False) -> dict:
        """One layer's parameters: with ``cross`` (a decoder layer of an
        encoder-decoder) ``norm_x`` and the ``cross`` attention; ``norm2``
        with an MoE ``ffn`` where ``is_moe``, else with a dense one where
        the config has ``d_ff``, else neither (the reference's
        ``_init_slot``)."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        layer = {"norm1": L.init_norm(cfg.d_model, dt, dev)}
        if kind == ATTN:
            layer["mixer"] = L.init_attention(generator, cfg, dt)
        elif kind == MLA:
            layer["mixer"] = L.init_mla(generator, cfg, dt)
        else:
            layer["mixer"] = M.init_mamba(generator, cfg, dt)
        if cross:
            layer["norm_x"] = L.init_norm(cfg.d_model, dt, dev)
            layer["cross"] = L.init_attention(generator, cfg, dt)
        if is_moe:
            layer["norm2"] = L.init_norm(cfg.d_model, dt, dev)
            layer["ffn"] = MOE.init_moe(generator, cfg, dt)
        elif cfg.d_ff:
            layer["norm2"] = L.init_norm(cfg.d_model, dt, dev)
            layer["ffn"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                      cfg.mlp_gated, cfg.num_layers, dt)
        return layer

    def init(self, generator: Optional[torch.Generator] = None) -> dict:
        """Random weights from ``generator`` (which lives on the model's
        device). The reference's init draws from ``jax.random``, so the two
        packages' random weights differ; ``bridge.from_jax`` carries the
        reference's weights across instead. A model on ``meta`` builds the
        tree's shapes and dtypes alone (the reference's ``jax.eval_shape``
        of its init) and takes no generator."""
        generator = self._generator(generator)
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
                "layers": [self._init_layer(generator, kind, is_moe,
                                            self.is_encdec)
                           for kind, is_moe in zip(self.kinds,
                                                   self.moe_flags)],
            }
            if not cfg.tie_embeddings:
                params["lm_head"] = L._init(
                    generator, (cfg.d_model, cfg.vocab_size), dtype=self.dtype)
            if self.with_value:
                params["value_head"] = {
                    "w": L._init(generator, (cfg.d_model, 1)),
                    "b": torch.zeros((1,), dtype=torch.float32,
                                     device=self.device)}
            if cfg.encoder_layers:
                params["encoder"] = [self._init_layer(generator, ATTN, False)
                                     for _ in range(cfg.encoder_layers)]
                params["encoder_norm"] = L.init_norm(cfg.d_model, self.dtype,
                                                     self.device)
            if cfg.mtp_depth:
                params["mtp"] = [self._init_mtp_module(generator)
                                 for _ in range(cfg.mtp_depth)]
        return params

    def _init_mtp_module(self, generator: torch.Generator) -> dict:
        """One MTP module: ``proj`` [2D, D] over the normed (h, emb) pair,
        ``norm_h``, ``norm_e`` and one layer of the kind the reference
        gives it (``repro/models/transformer.py:130-144``): its last
        segment's first slot, the period's first kind with that segment's
        MoE flag (DeepSeek-V3's: MLA and MoE; a model cut to its
        ``first_k_dense`` layers has a dense last segment, and so a dense
        MTP layer)."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        moe = cfg.moe is not None and cfg.num_layers > cfg.first_k_dense \
            and cfg.moe_period[0]
        return {"proj": L._init(generator, (2 * cfg.d_model, cfg.d_model),
                                dtype=dt),
                "norm_h": L.init_norm(cfg.d_model, dt, dev),
                "norm_e": L.init_norm(cfg.d_model, dt, dev),
                "layer": self._init_layer(generator, self._mtp_kind(), moe)}

    def _mtp_kind(self) -> str:
        return self.cfg.period[0]

    def _generator(self, generator):
        if generator is None and self.device.type == "meta":
            return L.SHAPE_ONLY
        if generator is None:
            raise ValueError(f"a model on {self.device} draws its weights "
                             "from a generator")
        return generator

    # -------------------------------------------------------- lora adapters
    def init_adapter(self, generator: Optional[torch.Generator], params,
                     rank: int, *, with_value: bool = False) -> dict:
        """Per-role LoRA adapter over ``params`` (``models/lora.py``); on
        ``meta`` shapes alone, with no generator."""
        return LORA.init_adapter(self._generator(generator), params, rank,
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
        """Token embeddings; under TP the vocab-parallel lookup (and the
        check that the config runs TP and ``params`` are a rank's cut)."""
        tp = TP.current()
        if tp is None:
            return params["embed"][tokens]
        TP.check_supported(self.cfg, tp.size)
        if params["embed"].shape[0] * tp.size != self.cfg.vocab_size:
            raise ValueError(
                f"under a TP group of {tp.size} the params must be a rank's "
                f"cut: embed has {params['embed'].shape[0]} of "
                f"{self.cfg.vocab_size} vocab rows")
        return tp.embed(params["embed"], tokens)

    def unembed(self, params, h: torch.Tensor) -> torch.Tensor:
        """Logits [..., V] (under TP the rank's V/ntp columns)."""
        h = L.rms_norm(h, params["final_norm"], self.cfg.norm_eps)
        w = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return L._column_input(h) @ w

    # -------------------------------------------------------------- full seq
    def _ffn(self, layer, h, ad):
        """The layer's FFN on the residual ``h`` -> (h, MoE aux loss or
        None): MoE where its ``ffn`` has a router (no adapter, as in the
        reference), else the dense MLP with its LoRA sites."""
        if "ffn" not in layer:
            return h, None
        cfg = self.cfg
        x2 = L.rms_norm(h, layer["norm2"], cfg.norm_eps)
        if "router" in layer["ffn"]:
            y, aux = MOE.moe_fwd(layer["ffn"], x2, cfg)
            return h + y, aux
        return h + L.mlp_fwd(layer["ffn"], x2, cfg.mlp_gated,
                             adapter=ad.get("ffn")), None

    def _slot_fwd(self, layer, kind, h, positions, *, window,
                  init_cache: Optional[dict] = None, adapter=None,
                  cross: Optional[dict] = None):
        """One layer -> (h, MoE aux loss or None, filled cache or None).
        ``cross`` (an encoder-decoder's decoder layer: its K/V over the
        encoder) adds the cross-attention between the mixer and the FFN.
        With ``init_cache`` (prefill) it also fills the
        layer's decode cache in the same pass: an attention layer's
        rolling KV cache, an MLA layer's latent cache, or a Mamba layer's
        conv and SSM states (copied into the cache's buffers). ``adapter``
        is the layer's LoRA subtree (unmerged A·B at the attention and MLP
        sites; an MLA mixer takes none, as in the reference)."""
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
        elif kind == MLA:
            y = L.mla_fwd(layer["mixer"], x, positions, cfg, window=window,
                          init_cache=init_cache)
            if init_cache is not None:
                y, cache = y
        elif init_cache is not None:
            y, state = M.mamba_fwd(layer["mixer"], x, cfg, return_state=True)
            for name, val in state.items():
                init_cache[name].copy_(val)
            cache = init_cache
        else:
            y = M.mamba_fwd(layer["mixer"], x, cfg)
        h, aux = self._ffn(layer, self._cross(layer, h + y, cross), ad)
        return h, aux, cache

    def _cross(self, layer, h, cross: Optional[dict]) -> torch.Tensor:
        """The residual ``h`` plus the layer's cross-attention over the
        encoder's K/V ``cross`` (``norm_x``, then ``cross``), where it has
        one."""
        if cross is None:
            return h
        xx = L.rms_norm(h, layer["norm_x"], self.cfg.norm_eps)
        return h + L.cross_attention_fwd(layer["cross"], xx, cross, self.cfg)

    def _stack_fwd(self, params, h, positions, *, window=0,
                   init_caches: Optional[List[dict]] = None, adapter=None,
                   layer_specs=None, cross_kv: Optional[List[dict]] = None):
        """Run every layer. Returns (h, aux, filled caches or None): aux is
        the sum of the MoE layers' load-balance losses (a 0-d fp32
        tensor; 0.0 without an MoE layer). ``adapter`` is a LoRA adapter
        over ``params``. With ``cfg.remat``
        other than "none" and grad mode on, each layer is one activation
        checkpoint (non-reentrant) under ``remat_policy_for(cfg.remat)``:
        its forward runs again in the backward, kernels included (the
        reference's ``jax.checkpoint`` per scanned layer group). "offload"
        moves only what the checkpoint saves, the layer's input, to host:
        the logits and the loss's residuals stay.

        ``layer_specs`` (a ``sharding.TreePlan.layer_specs``; by default
        the ambient ``sharding.ctx.segment_param_specs()``) is the ZeRO-3
        per-layer gather: ``params["layers"]`` holds the rank's shards and
        each layer is gathered just before it runs, its gathered leaves
        dead after it: under remat the gather runs inside the checkpoint,
        so the checkpoint keeps the shards and the recompute gathers
        again; without remat, in a recorded forward, the weights the
        layer's ops save for the backward are kept as shards and gathered
        again there (``LayerGather.saving_shards``). ``cross_kv`` (an
        encoder-decoder's, one dict a layer) feeds each layer's
        cross-attention."""
        lora = (adapter or {}).get("lora") or {}
        ads = lora.get("layers") or [None] * len(self.kinds)
        ckv = cross_kv or [None] * len(self.kinds)
        remat = self.cfg.remat != "none" and torch.is_grad_enabled() and \
            init_caches is None
        lg = layer_specs if layer_specs is not None \
            else ctx.segment_param_specs()

        def gathered(i, layer):
            return layer if lg is None else lg.gather(i, layer)

        if remat:
            ckpt_kw, around = remat_policy_for(self.cfg.remat)
        caches = []
        aux_total = 0.0
        for i, (kind, layer) in enumerate(zip(self.kinds, params["layers"])):
            if remat:
                with around():
                    h, a = checkpoint(
                        lambda hh, i=i, layer=layer, kind=kind, ad=ads[i]:
                        self._slot_fwd(gathered(i, layer), kind, hh,
                                       positions, window=window,
                                       adapter=ad, cross=ckv[i])[:2],
                        h, use_reentrant=False, **ckpt_kw)
                c = None
            elif lg is not None and torch.is_grad_enabled():
                # a recorded forward: the weights autograd saves are kept
                # as shards and gathered again by the backward
                with lg.saving_shards(i, layer) as full:
                    h, a, c = self._slot_fwd(full, kind, h, positions,
                                             window=window, adapter=ads[i],
                                             cross=ckv[i])
            else:
                h, a, c = self._slot_fwd(
                    gathered(i, layer), kind, h, positions, window=window,
                    init_cache=None if init_caches is None
                    else init_caches[i], adapter=ads[i], cross=ckv[i])
            caches.append(c)
            if a is not None:
                aux_total = aux_total + a
        return h, aux_total, (caches if init_caches is not None else None)

    def _positions(self, tokens: torch.Tensor) -> torch.Tensor:
        B, S = tokens.shape
        return torch.arange(S, device=tokens.device).expand(B, S)

    # ---------------------------------------------------------------- encode
    def encode(self, params, frame_embeds: torch.Tensor) -> torch.Tensor:
        """The bidirectional encoder over precomputed frame embeddings
        [B, Se, D] (the reference's ``encode``): each layer is attention
        with RoPE over positions 0..Se-1 through B2, non-causal, then its
        dense FFN; ``encoder_norm`` at the end. With ``cfg.remat`` other
        than "none" and grad mode on, each layer is one activation
        checkpoint, as the reference checkpoints its scanned encoder
        layer."""
        cfg = self.cfg
        h = frame_embeds
        sin, cos = L.rope_tables(self._positions(h[..., 0]),
                                 cfg.resolved_head_dim(), cfg.rope_theta)

        def layer_fwd(hh, layer):
            x = L.rms_norm(hh, layer["norm1"], cfg.norm_eps)
            q, k, v = L._project_qkv(layer["mixer"], x, cfg)
            q, k = L.apply_rope(q, sin, cos), L.apply_rope(k, sin, cos)
            o = L.attn_core(q, k, v, causal=False)
            hh = hh + o.reshape(*hh.shape[:2], -1) @ layer["mixer"]["wo"]
            x2 = L.rms_norm(hh, layer["norm2"], cfg.norm_eps)
            return hh + L.mlp_fwd(layer["ffn"], x2, cfg.mlp_gated)

        remat = cfg.remat != "none" and torch.is_grad_enabled()
        if remat:
            ckpt_kw, around = remat_policy_for(cfg.remat)
        for layer in params["encoder"]:
            if remat:
                with around():
                    h = checkpoint(layer_fwd, h, layer, use_reentrant=False,
                                   **ckpt_kw)
            else:
                h = layer_fwd(h, layer)
        return L.rms_norm(h, params["encoder_norm"], cfg.norm_eps)

    def _cross_kvs(self, params, enc_out: torch.Tensor) -> List[dict]:
        """Each decoder layer's cross-attention K/V over the encoder's
        output (the reference's ``_cross_kvs``)."""
        return [L.encode_cross_kv(layer["cross"], enc_out, self.cfg)
                for layer in params["layers"]]

    def _prepare_inputs(self, params, batch):
        """(h [B, S, D], positions [B, S], cross K/V or None) of a batch,
        as the reference's ``_prepare_inputs``: the token embeddings; with
        prefix embeddings, ``prefix_embeds`` in the tokens' dtype before
        them (S = P + tokens); for an encoder-decoder, the encoder's
        output's K/V for every decoder layer."""
        h = self.embed(params, batch["tokens"])
        cross_kv = None
        if self.cfg.input_mode == "embeddings":
            h = torch.cat([batch["prefix_embeds"].to(h.dtype), h], 1)
        elif self.is_encdec:
            enc = self.encode(params, batch["frame_embeds"].to(h.dtype))
            cross_kv = self._cross_kvs(params, enc)
        return h, self._positions(h[..., 0]), cross_kv

    def forward(self, params, batch, *, window: int = 0, adapter=None,
                layer_specs=None):
        """Full-sequence forward -> (logits [B,S,V], aux, h_final), as the
        reference's: aux is the MoE load-balance loss (a 0-d fp32 tensor
        on an MoE model, 0.0 on one without MoE layers). ``adapter``
        (a LoRA adapter) is applied unmerged; ``layer_specs`` gathers a
        ZeRO-3 tree's layers one at a time (:meth:`_stack_fwd`). The
        caller picks the grad mode: training differentiates through it,
        scoring runs it under ``torch.no_grad()``."""
        h, positions, cross_kv = self._prepare_inputs(params, batch)
        h, aux, _ = self._stack_fwd(params, h, positions, window=window,
                                    adapter=adapter, layer_specs=layer_specs,
                                    cross_kv=cross_kv)
        return self.unembed(params, h), aux, h

    def forward_value(self, params, batch, adapter=None,
                      layer_specs=None) -> torch.Tensor:
        """[B,S] per-token fp32 values (critic / reward): the trunk with
        ``adapter``, the final norm, then the adapter's value head (the
        hydra engine's critic and reward share a headless trunk), or
        without one the model's own ``params["value_head"]``."""
        h, positions, cross_kv = self._prepare_inputs(params, batch)
        h, _, _ = self._stack_fwd(params, h, positions, adapter=adapter,
                                  layer_specs=layer_specs, cross_kv=cross_kv)
        h = L.rms_norm(h, params["final_norm"], self.cfg.norm_eps)
        vh = (adapter or {}).get("value_head") or params["value_head"]
        return (h.float() @ vh["w"] + vh["b"])[..., 0]

    # ------------------------------------------------- multi-token prediction
    def _mtp_module_fwd(self, module, h_prev, e_next, positions, *,
                        window: int = 0) -> torch.Tensor:
        """One MTP module: combine h^{d-1} with emb(t_{i+d}) and run the
        module's layer. Returns h^d (pre-final-norm)."""
        eps = self.cfg.norm_eps
        h_in = torch.cat([L.rms_norm(h_prev, module["norm_h"], eps),
                          L.rms_norm(e_next, module["norm_e"], eps)], -1)
        return self._slot_fwd(module["layer"], self._mtp_kind(),
                              h_in @ module["proj"], positions,
                              window=window)[0]

    def mtp_logits(self, params, h, tokens) -> torch.Tensor:
        """DeepSeek multi-token prediction: predict t_{i+2} from h_i and
        emb(t_{i+1}), over the full (shifted, end-padded) sequence. Returns
        logits [B, S, V] where index i scores tokens[:, i+2] (the last two
        positions are padding — the loss masks them)."""
        shifted = torch.nn.functional.pad(tokens[:, 1:], (0, 1))
        hh = self._mtp_module_fwd(params["mtp"][0], h,
                                  self.embed(params, shifted),
                                  self._positions(tokens))
        return self.unembed(params, hh)

    def mtp_chain_logits(self, params, h, tokens, *, window: int = 0
                         ) -> List[torch.Tensor]:
        """Depth-k chained MTP (arXiv:2412.19437): module d consumes
        h^{d-1} and emb(tokens shifted by d) and predicts t_{i+d+1}.
        Returns one logits [B, S, V] a depth; entry d-1's index i scores
        tokens[:, i+d+1] (``steps.mtp_loss(offset=d+1)``). Depth 1 is
        :meth:`mtp_logits`. ``window=1`` trains the chain under the
        identity mask (each position sees only itself), the function
        :meth:`mtp_draft` evaluates at decode time."""
        positions = self._positions(tokens)
        out = []
        h_prev = h
        for d, module in enumerate(params["mtp"], start=1):
            shifted = torch.nn.functional.pad(tokens[:, d:], (0, d))
            h_prev = self._mtp_module_fwd(module, h_prev,
                                          self.embed(params, shifted),
                                          positions, window=window)
            out.append(self.unembed(params, h_prev))
        return out

    @torch.no_grad()
    def mtp_draft(self, params, h_last, first_tok, k_draft: int
                  ) -> torch.Tensor:
        """Draft ``k_draft`` greedy tokens from the MTP chain. ``h_last``
        [B, D] is the trunk state at position i (whose logits gave
        ``first_tok`` = t_{i+1}); the chain predicts t_{i+2}, t_{i+3}, ...
        Each module runs at one position, where attention is v(x) alone —
        independent of position and RoPE, the ``window=1`` chain — so
        drafts are a function of (h_last, first_tok). Depths beyond
        ``mtp_depth`` reuse the deepest module. Returns drafts [B, k]
        int64."""
        modules = params["mtp"]
        h = h_last[:, None]                               # [B, 1, D]
        tok = first_tok
        positions = torch.zeros(h.shape[:2], dtype=torch.int32,
                                device=h.device)
        drafts = []
        for d in range(k_draft):
            module = modules[min(d, len(modules) - 1)]
            e = self.embed(params, tok[:, None])
            h = self._mtp_module_fwd(module, h, e, positions)
            tok = torch.argmax(self.unembed(params, h)[:, 0].float(), -1)
            drafts.append(tok)
        return torch.stack(drafts, dim=1)

    # ------------------------------------------------------------- kv caches
    def init_cache(self, batch: int, capacity: int, dtype,
                   device=None) -> List[dict]:
        """One decode cache per layer: a rolling KV cache of ``capacity``
        slots for an attention layer, a rolling latent cache for an MLA
        layer; the conv and SSM states for a Mamba layer, whose size
        ``capacity`` does not touch. On the model's device unless
        ``device`` is given (a ``meta`` trace's)."""
        device = self.device if device is None else device
        make = {ATTN: lambda: L.init_kv_cache(self.cfg, batch, capacity,
                                              dtype, device),
                MLA: lambda: L.init_mla_cache(self.cfg, batch, capacity,
                                              dtype, device),
                MAMBA: lambda: M.init_mamba_cache(self.cfg, batch, dtype,
                                                  device)}
        return [make[kind]() for kind in self.kinds]

    @torch.no_grad()
    def prefill(self, params, batch, capacity: int, *, window: int = 0,
                lengths: Optional[torch.Tensor] = None,
                return_h: bool = False, adapter=None):
        """Process a prompt, returning (last-position logits [B,V], caches).
        caches = {"layers": [...], "cross_kv": [...] or None}: each layer's
        holds the last ``min(S, capacity)`` positions of a rolling buffer
        (prefix embeddings count among them); an encoder-decoder's
        ``cross_kv`` is each layer's K/V over the encoder, which the
        decode steps read. Single pass.

        ``lengths`` [B] (optional) marks per-row valid-token counts under
        right-padding: logits come from position ``lengths-1`` and padded
        cache entries are invalidated (their "pos" set to -1), exact
        because causal attention makes right-padding invisible to earlier
        positions. Attention and MLA layers only: a Mamba state cannot be
        masked after the fact, so a Mamba model raises on ``lengths``.
        ``return_h=True`` also returns the pre-final-norm hidden state at
        the logits position [B, D]. ``adapter`` (a LoRA adapter, here and
        on every cache path below) is applied unmerged, as in
        :meth:`forward`."""
        h_last, filled, cross_kv = self._prefill_h(
            params, batch, capacity, window, lengths, adapter)
        logits = self.unembed(params, h_last[:, None])[:, 0]
        caches = {"layers": filled, "cross_kv": cross_kv}
        if return_h:
            return logits, caches, h_last
        return logits, caches

    def _prefill_h(self, params, batch, capacity, window, lengths,
                   adapter=None):
        """The prefill's trunk: (hidden state at each row's last valid
        position [B, D], filled caches, cross K/V or None)."""
        if lengths is not None and MAMBA in self.kinds:
            raise ValueError(f"{self.cfg.name}: a lengths-masked prefill "
                             "cannot mask Mamba states after the fact")
        if lengths is not None and self.cfg.input_mode != "tokens":
            raise ValueError(f"{self.cfg.name}: a lengths-masked (bucketed) "
                             "prefill needs token inputs, as the "
                             "reference's")
        h, positions, cross_kv = self._prepare_inputs(params, batch)
        B = h.shape[0]
        init_caches = self.init_cache(B, capacity, h.dtype, h.device)
        h, _, filled = self._stack_fwd(params, h, positions, window=window,
                                       init_caches=init_caches,
                                       adapter=adapter, cross_kv=cross_kv)
        if lengths is None:
            return h[:, -1], filled, cross_kv
        idx = torch.clamp(lengths - 1, min=0).long()
        for c in filled:
            c["pos"].masked_fill_(c["pos"] >= lengths[:, None], -1)
        return h[torch.arange(B, device=h.device), idx], filled, cross_kv

    def _decode_h(self, params, tokens, mix, adapter=None,
                  cross_kv: Optional[List[dict]] = None) -> torch.Tensor:
        """A pass of ``tokens`` [B, T] over every layer; ``mix(i, mixer,
        x, ad)`` steps layer i's mixer on its cache (dense or paged KV, or
        Mamba states) under the mixer's LoRA sites ``ad`` (None without an
        adapter), then the cross-attention over the encoder where
        ``cross_kv`` has the layer's, then the layer's FFN (an MoE one
        routes these B*T tokens, idle rows included; its loss is dropped).
        -> h [B, T, D], pre-final-norm."""
        cfg = self.cfg
        lora = (adapter or {}).get("lora") or {}
        ads = lora.get("layers") or [None] * len(self.kinds)
        ckv = cross_kv or [None] * len(self.kinds)
        h = self.embed(params, tokens)
        for i, layer in enumerate(params["layers"]):
            ad = ads[i] or {}
            x = L.rms_norm(h, layer["norm1"], cfg.norm_eps)
            h = h + mix(i, layer["mixer"], x, ad.get("mixer"))
            h = self._cross(layer, h, ckv[i])
            h = self._ffn(layer, h, ad)[0]
        return h

    def _decode(self, params, token, mix, adapter=None,
                cross_kv: Optional[List[dict]] = None) -> torch.Tensor:
        """One-token pass over every layer -> logits [B,V]."""
        return self.unembed(params, self._decode_h(
            params, token[:, None], mix, adapter, cross_kv))[:, 0]

    @torch.no_grad()
    def decode_step(self, params, caches, token, position, *,
                    window: int = 0, adapter=None):
        """token [B] int, position [B] int32 -> (logits [B,V], caches);
        the caches are updated in place. A Mamba layer ignores
        ``position``; Mamba and MLA layers ignore the adapter, as in the
        reference. An MLA layer decodes absorbed, in the latent space. An
        encoder-decoder's layers attend over ``caches["cross_kv"]`` (B2
        over the encoder's K/V, read in place). With prefix embeddings
        ``position`` counts the prefix's slots (the caller offsets it)."""
        layers = caches["layers"]

        def mix(i, mixer, x, ad):
            if self.kinds[i] == ATTN:
                return L.attention_decode(mixer, x, position, layers[i],
                                          self.cfg, window=window,
                                          adapter=ad)[0]
            if self.kinds[i] == MLA:
                return L.mla_decode(mixer, x, position, layers[i], self.cfg,
                                    window=window)[0]
            return M.mamba_decode(mixer, x, layers[i], self.cfg)[0]

        return self._decode(params, token, mix, adapter,
                            caches.get("cross_kv")), caches

    # ------------------------------------------------------- paged kv caches
    def supports_paged(self) -> bool:
        """The paged backend covers token-input, attention-only nets; MLA
        and Mamba states are not paged (the reference's ``supports_paged``)."""
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
                      return_h: bool = False, adapter=None):
        """Prefill into paged pools: the dense single-pass prompt compute
        (capacity S, through the flash kernel), then each layer's K/V
        scattered to the sequences' pages, in place. batch["tokens"]
        [B, S]; block_tables [B, nb] int32; lengths [B] valid-token counts
        — logits come from position ``lengths-1``. Returns
        (last-valid-position logits [B, V], pools[, h_last])."""
        S = batch["tokens"].shape[1]
        h_last, filled, _ = self._prefill_h(params, batch, S, 0, lengths,
                                            adapter)
        for pool, c in zip(pools, filled):
            PC.scatter_prefill(pool, c["k"], c["v"], block_tables, lengths)
        filled.clear()                # the dense prefill cache was transient
        logits = self.unembed(params, h_last[:, None])[:, 0]
        if return_h:
            return logits, pools, h_last
        return logits, pools

    @torch.no_grad()
    def paged_decode_step(self, params, pools, token, position,
                          block_tables, *, adapter=None):
        """One-token decode over paged pools. token/position [B] (position
        is the logical index being written); block_tables [B, nb]. The
        pools are updated in place. Returns (logits [B, V], pools)."""
        logits = self._decode(params, token, lambda i, mixer, x, ad:
                              PA.paged_attention_decode(
                                  mixer, x, position, pools[i],
                                  block_tables, self.cfg, adapter=ad)[0],
                              adapter)
        return logits, pools

    @torch.no_grad()
    def paged_prefill_suffix(self, params, batch, pools, block_tables,
                             start, lengths, *, return_h: bool = False,
                             adapter=None):
        """Prefill only the suffix of a prompt whose prefix K/V already
        sits in the pools (a prefix-cache hit). batch["tokens"] [B, Sb]
        holds ``prompt[start:]`` right-padded; ``start`` [B] is each row's
        count of cached prefix tokens and ``lengths`` [B] its full prompt
        length. The suffix K/V is appended to the pools first and attention
        gathers from them (:meth:`paged_decode_multi`), so a query at
        position p sees cached prefix entries and earlier suffix entries
        through one mask: a cold run (start = 0) and a warm one compute
        the same function at each position. Returns (last-prompt-position
        logits [B, V], pools[, h_last [B, D]])."""
        tokens = batch["tokens"]
        B, Sb = tokens.shape
        j = torch.arange(Sb, dtype=torch.int32, device=tokens.device)[None]
        pos = start[:, None].to(torch.int32) + j
        positions = torch.where(pos < lengths[:, None], pos,
                                torch.full_like(pos, -1))
        logits_all, h_all, pools = self.paged_decode_multi(
            params, pools, tokens, positions, block_tables, adapter=adapter)
        idx = torch.clamp(lengths - start - 1, 0, Sb - 1).long()
        rows = torch.arange(B, device=tokens.device)
        logits = logits_all[rows, idx]
        if return_h:
            return logits, pools, h_all[rows, idx]
        return logits, pools

    # --------------------------------------------------- speculative decoding
    def supports_spec_decode(self) -> bool:
        """The draft/verify path covers token-input attention-only nets
        with MTP heads: rejected drafts need no rollback in a rolling cache
        or a paged pool (position masks hide them); MLA and Mamba states
        are not verified, as in the reference."""
        return self.cfg.input_mode == "tokens" and self.cfg.mtp_depth > 0 \
            and all(k == ATTN for k in self.kinds)

    def _check_attention_only(self, what: str) -> None:
        if any(k != ATTN for k in self.kinds) or \
                self.cfg.input_mode != "tokens":
            raise ValueError(f"{what} needs an attention-only token model")

    @torch.no_grad()
    def decode_multi(self, params, caches, tokens, positions, *,
                     window: int = 0, adapter=None):
        """T-token verify forward over the dense rolling caches. tokens
        [B, T], positions [B, T] absolute (consecutive per row; a row at
        -1 writes only dead entries). Returns (logits [B, T, V], h [B, T,
        D] pre-final-norm, caches); logits[:, j] scores the token at
        ``positions[:, j] + 1``. The caches are written in place. Entries
        of rejected drafts need no rollback: their positions exceed any
        later query's, so the mask hides them until they are
        overwritten."""
        self._check_attention_only("decode_multi")
        layers = caches["layers"]
        h = self._decode_h(params, tokens, lambda i, mixer, x, ad:
                           L.attention_decode_multi(
                               mixer, x, positions, layers[i], self.cfg,
                               window=window, adapter=ad)[0], adapter)
        return self.unembed(params, h), h, caches

    @torch.no_grad()
    def paged_decode_multi(self, params, pools, tokens, positions,
                           block_tables, *, adapter=None):
        """T-token verify forward over paged pools (the paged twin of
        :meth:`decode_multi`). tokens/positions [B, T]; -1 positions are
        dropped writes (idle or finished rows). The page manager must have
        grown each live row by T tokens first (``append_tokens``), and the
        caller truncates it back after acceptance. Returns (logits [B, T,
        V], h [B, T, D], pools)."""
        self._check_attention_only("paged_decode_multi")
        h = self._decode_h(params, tokens, lambda i, mixer, x, ad:
                           PA.paged_attention_decode_multi(
                               mixer, x, positions, pools[i], block_tables,
                               self.cfg, adapter=ad)[0], adapter)
        return self.unembed(params, h), h, pools
