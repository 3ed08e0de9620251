#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one NVIDIA card and nvcc
    python3 chip_smoke.py --profile  # also profiles one request per path
                                     # and one PPO iteration

Phases, each failing with a non-zero exit:

1. the card (``nvidia-smi`` name and power limit), versions, and the
   kernels' build from ``src/repro_torch/kernels/csrc``; the SASS of the
   bf16 flash, flash-backward and SSD-scan kernels must hold HGMMA
   (tensor-core) instructions and the kernels redesigned for Hopper (B2's
   wgmma kernel, B3's and B4's split and combine kernels, B5's wgmma
   kernel, B1's vector and scalar kernels) and the backward kernels
   (B2-bwd's three of each route, B1-bwd's three) must not spill registers
   (their ptxas lines are printed);
2. each kernel against its plain PyTorch version at the shapes of the
   serving, paged GRPO and Mamba2 paths and at edge cases (ragged Sq/Sk
   across the 128-row q and 64-key k tiles, Sk below one tile, a window
   that cuts tiles, a wrapped rolling cache, B3 with most splits empty,
   C below one split, G = 1 and 8 and a row with no valid slot, head_dim
   64, fp32; for B5 b and c as column slices of one xbc-like tensor, one
   chunk, N 64 with chunks of 64 and 128, a chunk of 512, small head and
   state widths, a strongly decaying a and the step-by-step oracle; for
   B1 each route of its plan; for B4 the paged GRPO step's forked table,
   all-distinct and all-same tables of its shape, ragged positions, an
   idle row in a tile, a ragged last tile, pages of two units and a forced
   single split; B2's lse output on every case; B2-bwd at the PPO
   training shape in bf16 (tensor cores) and fp32, D 64, G 1 and 8,
   windows, ragged S = 100, causal Sk above and below Sq and a full
   ragged Sq != Sk in both dtypes; B1-bwd, dx and dscale, at the
   training rows of both PPO paths, rows not even over its blocks and
   each route, dscale the same bits in two calls), with its time, the
   plain version's, one PyTorch library call's (where one exists) and
   the least time the card could take; every kernel also with its
   device time from CUDA-graph replay, warm and cold (inputs rotated
   through more than the 50 MB L2, as the path finds them), B1 at
   every path shape beside ``F.rms_norm``'s, B4 on each of
   its three tables with its plan and the pages each block copies; B2,
   B3 and B4 also at phase 17's head layouts (granite G 3 at D 64, qwen
   G 1 and jamba G 4 at D 128) and B5 at jamba's Mamba widths (H 128, P
   64, N 16, its CUDA-core route), B1 at each family's serving rows and
   d_model (jamba's gated norm at 8192), granite's GRPO and separate PPO
   rows, and B2-bwd and B1-bwd (with dscale) at granite's separate PPO
   training shape, each timed by graph replay, warm and
   cold, beside its bound and its library call's time where one exists;
   and at phase 18's shapes: B2 at deepseek's MLA head widths (q/k 192,
   v 128, 128 heads) at its serving prefill and its train step (with
   lse), B2-bwd at its train step (the CUDA-core route), both at windows,
   ragged Sq != Sk and fp32, B1 at d_model 7168 (the scalar route), 1536
   and 512 (q_norm, kv_norm) at the serving and training rows, and B1-bwd
   with dscale at the training rows; and at phase 19's: B2 at
   qwen1_5_110b's 64 / 8 and command_r_plus_104b's 96 / 8 heads of 128
   (G 8 and 12) at the serving prefill and a train microbatch (with lse),
   B2-bwd at the train microbatch, B3 and B4 at both layouts at the
   serving and paged GRPO decode steps and at G 12 and 16 in bf16 and
   fp32 at D 64 and 128 (fp32 held to 5e-5), B1 at 8192 and 12288 (the
   scalar route) at the serving, decode and train rows, B1-bwd with
   dscale at the train rows, 4096 and 8 rows (the last two held, not
   timed); and at phase 20's: B2 non-causal at seamless's encoder [8,
   1024 | 1024, 16 | 16, 64], its cross prefill [8, 512 | 1024] and one
   query over the 1024 frames, causal at internvl's [8, 768, 16 | 8,
   128], each at its train step's 4 rows too (with lse), B3 over the
   1024 all-valid frames (MHA, D 64: B2 at one query takes that step on
   the path) and at internvl's last decode step,
   B2-bwd at the three train shapes, fp32 Sq != Sk non-causal at D 64,
   B1 at internvl's prefill, decode and train rows at 2048 and seamless's
   encoder, prefill, decode and train rows at 1024, B1-bwd with dscale at
   the three train shapes;
3. the serving path: full-width, full-depth llama3_2_3b (28 layers, bf16,
   random weights from a seed) serves 3 requests of batch 8 x 512 prompt
   tokens + 64 generated, through ``repro_torch.launch.serve.run``; the
   kernels' launch counts must be exactly what that path makes;
4. the outputs: shapes, ranges and finite log-probs, and a small model
   on the card against the same model on the CPU (the plain path);
5. the paged GRPO rollout: the same model serves 2 requests of 8 prompts
   x 504 tokens, each forked into G = 8 samples of 64 tokens off one
   prefill, through ``Rollout(backend="paged").generate(group_size=8)``;
   launch counts (B4 on every decode step, B3 never) and page-manager
   stats are asserted, and one dense request of the same prompts repeated
   8 times is run beside it: request time, peak memory above the weights
   (the paged fork's must be the lower), and the two results' first
   sampled tokens (identical) and log-probs (within bf16 rounding).
6. Mamba2 serving: full-width, full-depth mamba2_370m (48 layers,
   d_model 1024, bf16, random weights from a seed) serves 3 requests of
   batch 8 x 2048 prompt tokens + 64 generated through
   ``serve.run``, through B5 (the SSD chunk scan, once per layer in each
   prefill) and B1; launch counts asserted, outputs checked, the prefill
   and decode step timed apart, and a small Mamba model on the card
   against the CPU (16 greedy tokens identical).
7. the paper's workload: 2 hydra PPO iterations (the seven phases of
   ``RUNTIME_RLHF_PHASE_SEQUENCE``) of full llama3_2_3b with rank-128
   adapters, 8 prompts x (512 + 64), remat="full", the reward adapter
   scoring, through ``RLHFTrainer.train_step``; the launches of all seven
   counters per iteration asserted (``ppo_launches``), losses finite,
   trunk unchanged bit for bit, adapters moved; each phase's ms and
   live/reserved/peak MiB above the weights printed, then again for one
   iteration under memory_policy="none"; a small model's 2 greedy fp32
   PPO steps on the card against the CPU.
8. the paper's four-model PPO (``engine="separate"``, full-parameter
   training) on its own pair: an opt_1_3b actor and reference, an
   opt_350m critic and reward model (24 layers each, MHA at head_dim 64,
   bf16), 8 prompts x (256 + 256), the reward model scoring; 2 iterations
   with the launches of all seven counters asserted (``ppo_launches``
   from each config's depth; B1-bwd with dscale at every norm), finite
   metrics, the reference and reward models unchanged bit for bit,
   every trained leaf given a gradient and moved (bar the bf16 norm
   scales, whose lr-1e-5 steps round away), the persistent bytes equal to
   the six trees' ``nbytes``; per-phase ms and MiB, then one iteration
   under memory_policy="none", one hydra iteration of opt_1_3b at the
   same shape, ``memory_accounting`` of llama3_2_3b, and a small model's
   2 greedy fp32 separate iterations on the card against the CPU.
9. host offload (``RLHFConfig.offload``, ``repro_torch.offload``): the
   separate OPT pair of phase 8, at full width and 8 of its 24 layers
   (``STUDY_LAYERS``), at ``none`` twice (does the card repeat
   itself bit for bit?), then a fresh trainer at each of ``optimizer``,
   ``roles`` and ``all``, and at ``roles`` under memory_policy="none",
   each one warm and one measured iteration: the bytes left on the card
   after the initial parks held to the trees' ``nbytes``, launches
   (``ppo_launches``), metrics equal to ``none``'s, the reference and
   reward models bit for bit, every record's live bytes below ``none``'s
   by at least the bytes parked there; hydra llama3_2_3b at phase 7's
   shape at ``none`` and at ``all``, the rollout's mid-phase sample below
   ``none``'s by at least the trunk's adapted leaves; one actor step's
   forward and backward under remat "full", "offload" (gradients bit for
   bit "full"'s) and "dots" (within 2e-2), launches equal; and a 1 GiB
   pinned copy each way as the link's yardstick. Per phase: ms, park and
   fetch ms, GB moved and GB/s, live/reserved/peak/host MiB and the state
   on the card; the host's MemTotal/MemAvailable before and after.

10. decode graphs (``rlhf/decode_graph.py``): every decode path eagerly
   and graphed in this call, from one seed — serving llama3_2_3b 8 x
   (512 + 64), the paged GRPO rollout (8 x 504, G = 8, 64 generated),
   mamba2_370m 8 x (2048 + 64), the hydra PPO rollout of llama3_2_3b 8 x
   (512 + 64) and the separate PPO rollout of opt_1_3b 8 x (256 + 256):
   tokens and log-probs the same bits (sampled, and greedy), launches and
   the live bytes after each call equal; ms a decode step both ways, the
   capture's ms and the graph pool's MiB; the paged step's host time
   split between the page manager and the rest; one PPO iteration each
   way on both engines (the rollout boundary's live bytes equal); with
   ``--profile`` the idle share of a graphed and an eager serving call and
   of a graphed paged GRPO call, each with the kernels in its trace held
   to ``ops.launches`` for it.

11. the paper's memory study on the card (``repro_torch.core``): phase
   8's OPT pair at phase 9's 8 layers, with decode eager (the simulator
   models one pool, a graph keeps its own) under each ``empty_cache`` policy, a warm, a timed and
   a recorded iteration (the last from an emptied cache, with the caching
   allocator's history on, no stack context); per phase the card's live,
   reserved and peak bytes and cudaMallocs; the recorded stream replayed
   through ``core.CachingAllocator`` (the stream's live requested bytes
   must equal ``requested_bytes.all.current`` at every boundary);
   ``run_iteration`` on the port's own ``meta`` traces of the same
   programs beside it, each trace's peak beside the card's and
   ``train_actor``'s broken down by tag and op; the simulated state on
   the card and host at each offload level held to phase 9's per
   boundary, to the MiB; one iteration at remat "full"; R1-R3 as the card
   shows them beside the simulator; and ``GRPOTrainer`` on opt_1_3b at
   ``build_grpo_phases``' shape (2 prompts x G 8, 256 + 256, paged),
   launches asserted (B3 never), beside the simulator.

12. runtime telemetry (``repro_torch.obs``): phase 8's OPT pair, 2
   iterations with ``RunTelemetry.create(sim_delta=True, annotate=True)``,
   the trainer's memory attributor and a flight recorder at watermark
   0.2: launches asserted, metrics equal to phase 8's same-seed
   iterations to the bit; 7 phase spans an iteration tiling it; at every
   record the owner table plus residue equal to ``memory_allocated``, the
   six state owners their trees' bytes within the allocator's rounding;
   the simulator's bytes on every span (printed beside the measured, with
   the owner table); the watermark dump; self-time at most 2% of an
   iteration; the JSONL rendered by ``launch.report``; then a fresh
   trainer capped at 0.31 of the card must raise
   ``torch.cuda.OutOfMemoryError`` in train_actor with its dump. With
   ``--profile`` the phases must be user annotations of a profiler trace.
   Files: ``chiprun_out/telemetry.jsonl``, ``telemetry_trace.json``,
   ``telemetry_report.txt``, ``flight_watermark.json``,
   ``flight_oom.json``.

13. MTP self-speculative decoding (``Rollout(spec_decode=)``,
   ``RLHFConfig.spec_decode``): (a) full-width llama3_2_3b with 2 random
   MTP heads (bf16, from a seed), 8 x (512 + 64), spec_k 2, on the dense
   and the paged backend: vanilla greedy, the spec rollout graphed and
   eager (the same bits), launches as reckoned (``spec_launches``: B3 and
   B4 never), pages invariant and all free after each call; the eager
   verify's logits against an fp32 forward of the same tokens, whose
   largest per-query RMS error must be within 2x vanilla's decode steps'
   against an fp32 forward of vanilla's tokens, and an off-by-one mask
   planted in the verify's attention, either way, must fail that check;
   the rows that leave vanilla greedy's tokens, and where, printed; ms a
   verify step, ms an emitted token beside vanilla's ms a step, accept
   rate, peak MiB above the weights; (b) the same with ``forced_drafts``
   standing in for the heads' drafts (the spec run's own continuation:
   full acceptance; the heads still run, their drafts dropped); (c) the
   reference's decode bench (its tiny llama at mtp_depth 3, head_dim 64,
   trained 300 steps on the cyclic-token task through the port, then 4 x
   (8 + 64) greedy vanilla against spec: tokens bit for bit, logp within
   1e-5, accept rate at least 0.90; speedup printed); (d) a small model's
   2 greedy spec PPO steps on the card against the CPU on both engines;
   (e) one hydra spec PPO iteration of phase 7's shape with 2 MTP heads:
   launches asserted, per-phase ms and MiB, the actor's ``mtp_loss``.

14. the continuous batcher (``serving/scheduler.py::ContinuousBatcher``):
   full-width llama3_2_3b (bf16, random weights from a seed), 8 slots over
   a 1024-token capacity, buckets (2, 4, 8, 64, 128, 256, 512) (slot rungs
   2, 4 and 8), greedy traffic with no EOS: 32 requests of 32-480 prompt
   tokens and 16-96 new ones on the dense backend, the paged one, and a
   paged pool of a third of the dense reservation (admission waits on
   pages, a request is preempted); 16 requests sharing a 256-token system
   prompt with the prefix cache, two tenants weighted 2:1; 8 requests of
   spec decode (k 2, phase 13's 2-head model) on both backends. Each run
   graphed (one CUDA graph a decode rung, captured at warmup) and eager:
   the same tokens, steps, launches and pages at every step; every
   request at its length, no recompile after warmup, launches as the
   run's own prefills and steps imply (``batcher_launches``), the pool
   empty after (with the prefix cache only its parked pages); after
   ``update_params`` to a second seed's weights the graphed batcher's
   tokens are a fresh eager batcher's (dense, paged, prefix; there the
   first admission hits no old prefix). Printed: ms a decode-only step at
   each rung graphed and eager, tok/s, pages in use, reserved KV against
   dense, admission latency p50/p99, each graph's capture ms and pool, peak
   memory above the weights; then a small f32 batcher on the card against
   the CPU on both backends, the prefix cache and spec decode.

15. ZeRO data parallelism (``repro_torch.sharding``,
   ``RLHFTrainer(shard=)``): (a) over NCCL at ndp 1, phase 8's OPT pair
   (separate) and phase 7's hydra llama3_2_3b, each at ZeRO-1 and at
   ZeRO-3 with per-layer gathers, one iteration each:
   metrics bit for bit phases 7 and 8's unsharded first iteration,
   launches as theirs; (b) two ranks over
   gloo on the one card (``torch.multiprocessing`` spawn, both on
   ``cuda:0``; every collective stages through pinned host memory), the
   separate OPT pair at 8 of its 24 layers (``_study_pair``) with 7
   prompts (ndp 2 does not divide 7: the batch replicates) at ZeRO-1, ZeRO-3 ``tree`` and ZeRO-3 ``layer``, one
   iteration each: metrics bit for bit a one-rank run of the same
   prompts, and the trained trees after the sharded update (gathered)
   the same bits by fingerprint; each rank's persistent state bytes, per-phase peak
   ``max_memory_allocated`` and reserved-minus-allocated, and train
   peak printed with the simulator's prediction; ZeRO-3 must keep at most
   0.55 of ndp 1's persistent bytes on a rank, and ``layer`` must peak in
   training below ``tree`` by at least half of (actor tree - one layer).

16. Megatron tensor parallelism (``sharding/tp.py``,
   ``ShardedContext.create(model=2)``): two ranks over gloo on the one
   card at (ndp 1, ntp 2), each holding its half of every Megatron cut.
   (a) One separate iteration of phase 8's OPT pair at full width and
   ``TP_LAYERS`` (6) of its 24 layers (8 x (256 + 256), bf16), the whole
   trees drawn from seed 0 and
   cut: launches per kernel phase 8's (``ppo_launches``), a rank's
   persistent bytes at most 0.55 of ntp 1's and within 0.1% of
   ``traced_zero_scales(ntp=2)``'s prediction (printed beside it);
   iteration ms, staged GB and the all-reduce count printed. (b) The
   numerics check of phase 13's kind: the rank's reference actor
   teacher-forced on the tokens of a one-rank rollout of the same actor;
   its log-probs' RMS error against an fp32 forward must be within 2x
   the one-rank bf16 forward's, and with one row all-reduce skipped (a
   planted fault) must not be; both ratios printed. (c)
   ``ContinuousBatcher(mesh=)`` on llama3_2_3b at full width (4 slots
   over 640 tokens, 3 greedy requests of phase 14's mixed traffic of at
   most 24 new tokens), dense
   and paged: launches as its calls imply (``batcher_launches``), every
   request at its length, the KV a rank half of ntp 1's. The decode loops
   run eagerly: a gloo collective stages through host memory and cannot
   be captured (capture over NCCL needs a machine with more than one
   card). Nothing across cards is measured. From a Python prompt
   ``chip_smoke.tp_ppo(torch.device("cuda"), print)`` runs it alone after
   ``build.build()``.

17. three more model families at full width, random weights from a
   seed (``families``): (a) qwen1_5_4b (40 layers, MHA of 20 heads of
   128, qkv bias, an untied 151,936-column head) and (b)
   granite_moe_3b_a800m (32 layers, every FFN MoE: 40 experts, top 8)
   each serve 3 requests of 8 x (512 + 64) through ``serve.run``, launches
   as ``serve_launches`` reckons them (``step_norms``: every MoE layer's
   norm2); one greedy granite request graphed and eager, the same bits
   and launches; (c) one paged GRPO request of granite at phase 5's
   shape (8 prompts x 504, G = 8, 64 new tokens), launches and page stats;
   (d) a paged ``ContinuousBatcher`` drain of granite (8 slots, 8 mixed
   requests) graphed against eager, token for token; (e)
   jamba_v0_1_52b at one period, 8 of its 32 layers (seven Mamba layers
   with FFNs, four of them MoE, and one attention layer; the whole model
   does not fit one card), 3 requests of 8 x (512 + 64), B5 on its CUDA-
   core route; (f) one separate PPO iteration of granite, 8 x (256 +
   256), remat "full", the actor and reference at full depth and the
   critic and reward model at 8 layers (running out of memory fails the
   phase), launches asserted (``ppo_launches``), per-phase
   ms and MiB; (g) the granite and jamba smoke configs on the card
   against the CPU. With ``--profile``, where an eager granite decode
   step's device time goes: the MoE FFN's routing, expert products,
   dispatch and combine, the attention mixer, B1. From a Python prompt
   ``chip_smoke.families(torch.device("cuda"), print, "")`` runs it alone
   after ``build.build()``.

18. deepseek_v3_671b (MLA layers, a dense leading segment, 256-expert
   MoE, MTP, Adafactor) at full width, random weights from a seed
   (``deepseek``): (a) serving at 4 of its 61 layers (its 3 dense layers
   and its first MoE one) and its MTP module, 26.7B params, 3 greedy
   requests of 8 x (512 + 64), decode graphed, launches as
   ``serve_launches`` reckons them (B2 once an MLA layer, no B3: the
   latent-space decode is plain products), request 0 again eager to the
   same tokens, the decode cache's bytes a token against expanded K and
   V's; (b) one Adafactor ``make_train_step`` of 2 x 256 tokens with the
   trunk cut to its first dense layer, its MTP module (the reference's MTP
   layer takes its last segment's kind: MLA with a dense FFN here) and
   the MTP loss, at 2 microbatches (bf16 accumulation); (c) one on one
   MoE layer (256 routed experts and the shared one), at one microbatch;
   each with launches asserted (``train_launches``), the peak against the
   reckoning and Adafactor's state bytes; (d) a small MLA model (q/k 192,
   v 128, f32) on the card against the CPU, prefill, greedy tokens and two
   Adafactor steps' metrics. From a Python prompt ``chip_smoke.deepseek(
   torch.device("cuda"), print, "")`` runs it alone after
   ``build.build()``. Phase 16 runs the OPT pair at 12 of its 24 layers
   (``TP_LAYERS``) since then, and at 6 since phase 20, to leave the
   script room.

19. qwen1_5_110b (80 layers, d_model 8192, 64 / 8 heads: G 8, qkv bias,
   untied) and command_r_plus_104b (64 layers, d_model 12288, 96 / 8
   heads: G 12, tied), both with adamw_bf16, at full width, random
   weights from a seed (``big_dense``): (a) qwen at 8 of its 80 layers
   (13.4B params) serves 3 greedy requests of 8 x (512 + 64), decode
   graphed, launches as ``serve_launches`` reckons them, request 0 again
   eager to the same tokens, then one paged GRPO request of phase 5's
   shape (B4 at G 8); (b) command-r at 6 of its 64 layers (12.6B) the
   same through B3 and B4 at G 12, then a dense and a paged
   ``ContinuousBatcher`` drain of 8 mixed requests, each graphed against
   eager token for token; (c) one adamw_bf16 ``make_train_step`` of 2
   microbatches of 2 x 256 tokens of each (qwen at 3 layers, command-r at
   2: ~10 GB of the card left), launches asserted (``train_launches``),
   its ms and the update's, its peak against params + moments + two bf16
   gradient sets, the optimizer's bytes against adamw's fp32 moments; (d)
   AdamW on qwen's 403M-element FFN leaf in fp32 block by block against
   one whole-leaf block, bit for bit; (e) command-r's smoke config at G
   12 (12 query heads over 1 KV head) on the card against the CPU. From a
   Python prompt ``chip_smoke.big_dense(torch.device("cuda"), print,
   "")`` runs it alone after ``build.build()``.

20. internvl2_2b (24 layers, d_model 2048, 16 / 8 heads of 128, 256
   patch embeddings before each prompt) and seamless_m4t_large_v2 (a
   24-layer encoder over 1024 frame embeddings, 24 decoder layers each
   with cross-attention over the encoder's output, d_model 1024, 16 / 16
   heads of 64, an ungated FFN, a 256,206-column head) at full width and
   depth, random bf16 weights from a seed, the embeddings from a seeded
   generator at 0.01 (``embeddings``): (a) 3 greedy dense rollout calls
   of each of 8 x (512 + 64) tokens with the embeddings in the batch,
   decode graphed, launches as ``emb_serve_launches`` reckons them
   (seamless: the encoder's B2 non-causal, the cross-attention's B2 at
   Sq != Sk in the prefill and at one query over the 1024 frames in each
   decode step), request 0 again eager to the same tokens, the live bytes
   after each request its before, seamless's cross K/V bytes as reckoned;
   (b) two ``make_train_step`` ppo steps of each, 4 x (256 + 512) and 4 x
   512 over 1024 frames, remat "full", AdamW, launches asserted
   (``emb_train_launches``), the peak against the reckoning, probed
   leaves moved (the encoder's too); (c) each smoke config on the card
   against the CPU. Phase 2 holds B2 at its encoder, cross-prefill,
   one-query and internvl shapes and their train steps, B3 at the
   cross-decode shape and B2-bwd at the train shapes, each timed. From a
   Python prompt ``chip_smoke.embeddings(torch.device("cuda"), print,
   "")`` runs it alone after ``build.build()``.

Phases 3, 5-9, 12-15 and 17-20 run graphed, the default on the card
(phase 16 eager, as above): every
decode step after a call's first replays its captured step (in a call of
two decode steps or more; the batcher's graphs live as long as it does),
and the launch counts they assert are the eager path's
(``ops.capturing``).

It prints the per-kernel JSON line, the card line, and last the result
line ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.data import PromptDataset, \
    synthetic_instruction_prompts  # noqa: E402
from repro_torch import steps as TS  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as LAYERS  # noqa: E402
from repro_torch.models import lora as LORA  # noqa: E402
from repro_torch.offload.compat import pinned_buffer  # noqa: E402
from repro_torch.optim import AdamW, make_optimizer  # noqa: E402
from repro_torch.optim import adamw as ADAMW  # noqa: E402
from repro_torch.paged import PageManager, gather_kv  # noqa: E402
from repro_torch.rlhf import (ModelEngine, RLHFConfig, RLHFTrainer,  # noqa: E402
                              Rollout)
from repro_torch.core import (POLICIES, CachingAllocator,  # noqa: E402
                              MemoryStrategy, OFFLOAD_LEVELS,
                              RUNTIME_RLHF_PHASE_SEQUENCE, build_grpo_phases,
                              build_rlhf_phases, run_iteration,
                              traced_strategy, traced_zero_scales)
from repro_torch.rlhf import GRPOConfig, GRPOTrainer  # noqa: E402
from repro_torch.serving import ContinuousBatcher  # noqa: E402
from repro_torch.sharding import ShardedContext, delete_tree  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402
from repro_torch.tree import nbytes as tree_nbytes  # noqa: E402

OUT_DIR = ROOT / "chiprun_out"

# serving path: llama3_2_3b, batch 8, prompt 512, 64 generated tokens
BATCH, PROMPT, GEN, REQUESTS = 8, 512, 64, 3
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # other summation order
# B1-bwd: the scaled error of dx and dscale, at the forward kernels' fp32
# tolerance (tests/test_kernels.py:15)
TOL_RMS_BWD = {torch.bfloat16: 2e-2, torch.float32: 5e-5}
# paged GRPO rollout: 8 prompts of 504 tokens (not a multiple of the page
# size, so each forked row CoW-copies its partial prompt page), G = 8
# samples each, 64 generated tokens, 2 requests
GROUPS, GPROMPT, GSIZE, PAGE, GREQUESTS = 8, 504, 8, 16, 2
# Mamba2 serving: mamba2_370m, batch 8, prompt 2048 (Mamba2's training
# context, a multiple of the 256-step SSD chunk), 64 generated tokens
MBATCH, MPROMPT, MREQUESTS = 8, 2048, 3
TOL_SSD = {torch.bfloat16: 5e-2, torch.float32: 1e-3}   # test_kernels.py:98
# PPO iteration: llama3_2_3b, hydra engine, rank 128, 8 prompts of 512 + 64
# generated tokens, 2 iterations (and one more under memory_policy="none")
PBATCH, PPROMPT, PITERS = 8, 512, 2
# speculative decoding (phase 13): llama3_2_3b with 2 MTP heads (random,
# from a seed) at the serving shape, 8 x (512 + 64), spec_k 2
SPEC_K, SPEC_DEPTH = 2, 2
# separate PPO (phase 8): the paper's own pair (DeepSpeed-Chat), an
# opt_1_3b actor and reference and an opt_350m critic and reward model, 8
# prompts x (256 + 256), the lengths build_rlhf_phases traces by default
SEP_ACTOR, SEP_CRITIC = "opt_1_3b", "opt_350m"
SBATCH, SPROMPT, SGEN, SITERS = 8, 256, 256, 2
SLEN = SPROMPT + SGEN
# phases 9 (its separate runs) and 11 run the OPT pair at full width and
# at 8 of its 24 layers, so that the script keeps room in its time limit
STUDY_LAYERS = 8
# phase 17: three more families at full width, random weights from a seed.
# Phase 2 holds B2-B4 at their head layouts (query / KV heads of D) and B5
# at jamba's Mamba widths; FAMILY_HEADS[name] = (H, K, D)
FAMILY_HEADS = {"granite": (24, 8, 64), "qwen": (20, 20, 128),
                "jamba": (32, 8, 128)}
# and B1 at their d_model (jamba's gated norm at its Mamba d_inner, 8192)
FAMILY_WIDTHS = {"granite": 1536, "qwen": 2560, "jamba": 4096}
JAMBA_D_INNER = 8192
QWEN, GRANITE, JAMBA = "qwen1_5_4b", "granite_moe_3b_a800m", "jamba_v0_1_52b"
# jamba serves one period, 8 of its 32 layers (52B params do not fit one
# card: one period is ~12.9B, 25.7 GB in bf16)
JAMBA_LAYERS = 8
FAM_REQUESTS = 3                 # each family serves 3 x 8 x (512 + 64)
FAM_CB_REQUESTS = 8              # granite's batcher drain, 8 slots
# granite's separate PPO iteration: the actor and reference at full depth
# (32 layers), the critic and reward at 8, 8 x (256 + 256), remat "full"
GRANITE_CRITIC_LAYERS = 8
# phase 16's separate iteration on the OPT pair: at full width and at 6
# of its 24 layers, so that the script keeps room for phases 18-20
TP_LAYERS = 6
# phase 18: deepseek_v3_671b at full width, random weights from a seed.
# MLA attends with q/k heads of 192 (nope 128 + rope 64) and v heads of 128
DEEPSEEK = "deepseek_v3_671b"
MLA_HEADS = (128, 128, (192, 128))            # (H, K, (D, Dv)), G 1
DS_WIDTHS = {"d_model": 7168, "q_lora": 1536, "kv_lora": 512}
# serving: its 3 dense layers and its first MoE layer (256 routed experts
# and a shared one) of 61, and its MTP module (671B do not fit one card; 4
# layers and the MTP module are 26.7B, 53.4 GB in bf16)
DS_SERVE_LAYERS = 4
# one Adafactor train step of 2 x 256 tokens (kind "lm"): (a) the trunk cut
# to its first dense layer, with its MTP module and the MTP loss, at 2
# microbatches (bf16 accumulation); (b) one MoE layer, at one microbatch
DS_TBATCH, DS_TSEQ = 2, 256
# a train step's peak above its reckoning (the state and its bf16
# gradients): activations, the MoE's dispatch and Adafactor's blocks
DS_PEAK_SLACK = 8 * 2**30

# phase 19: the two dense >= 100B configs at full width, random bf16
# weights from a seed, both with adamw_bf16 (bf16 moments). qwen1_5_110b
# has 64 / 8 heads of 128 (G 8) at d_model 8192, command_r_plus_104b 96 / 8
# (G 12) at 12288; phase 2 holds B2-B4 at these head layouts and B1 at
# these widths. BIG_HEADS[name] = (H, K, D)
QWEN110, CMDR = "qwen1_5_110b", "command_r_plus_104b"
BIG = {"qwen110": QWEN110, "cmdr": CMDR}
BIG_HEADS = {"qwen110": (64, 8, 128), "cmdr": (96, 8, 128)}
BIG_WIDTHS = {"qwen110": 8192, "cmdr": 12288}
# serving and the rollouts at 8 of qwen's 80 layers and 6 of command-r's 64
# (111B and 104B params do not fit one card; the cut models are 13.4B and
# 12.6B, 26.7 and 25.2 GB in bf16)
BIG_SERVE_LAYERS = {"qwen110": 8, "cmdr": 6}
# one adamw_bf16 train step of kind "lm", 2 microbatches of 2 x 256 tokens
# (the configs' own microbatches), at the depth that leaves ~10 GB of the
# card free: bf16 params, bf16 moments and, at 2 microbatches, two bf16
# gradient sets (the accumulators and a microbatch's), 10 bytes a param
# (qwen 3 layers: 6.57B params, ~66 GB; command-r 2: 6.29B, ~63 GB)
BIG_TRAIN_LAYERS = {"qwen110": 3, "cmdr": 2}
BIG_TBATCH, BIG_TSEQ = 4, 256
BIG_CB_REQUESTS = 8              # command-r's batcher drains, 8 slots
# qwen1_5_110b's FFN leaf [d_model, d_ff]: 403M elements, the blocked
# AdamW update held to the whole-leaf one bit for bit
BIG_FFN_LEAF = (8192, 49152)
# phase 2's fp32 tolerance for B3 and B4 at groups over 8 (the gpu
# tests', tests/test_kernels.py:15)
TOL_GROUP = {torch.bfloat16: 2e-2, torch.float32: 5e-5}

# phase 20: prefix-embedding and encoder-decoder inputs at full width and
# depth, random bf16 weights from a seed. internvl2_2b: 256 patch
# embeddings before each prompt, 16 / 8 heads of 128; seamless_m4t_large_v2:
# a 24-layer encoder over 1024 frame embeddings and cross-attention in each
# of its 24 decoder layers, 16 / 16 heads of 64. EMB_HEADS[name] = (H, K, D)
VLM, AUDIO = "internvl2_2b", "seamless_m4t_large_v2"
EMB = {"internvl": VLM, "seamless": AUDIO}
EMB_HEADS = {"internvl": (16, 8, 128), "seamless": (16, 16, 64)}
EMB_PREFIX, EMB_FRAMES = 256, 1024
EMB_SCALE = 0.01            # the embeddings' scale (tests/test_models.py:33)
EMB_TBATCH = 4              # the ppo train steps' rows
# phase 2's cases added for phase 20 (their names' prefixes) draw their
# inputs from a generator of their own (PHASE20_SEED), so that every earlier
# case keeps the inputs it had: on other inputs B5's main case read
# 5.231e-2 against its 5e-2 (ROADMAP §C)
PHASE20_CASES, PHASE20_SEED = ("internvl", "seamless", "xattn"), 20
# B2's shapes on phase 20's paths: (name, Sq, Sk, heads, causal)
EMB_B2_SHAPES = (
    ("internvl", EMB_PREFIX + PROMPT, EMB_PREFIX + PROMPT,
     EMB_HEADS["internvl"], True),
    ("seamless_enc", EMB_FRAMES, EMB_FRAMES, EMB_HEADS["seamless"], False),
    ("seamless_cross", PROMPT, EMB_FRAMES, EMB_HEADS["seamless"], False),
    ("seamless_xdec_q1", 1, EMB_FRAMES, EMB_HEADS["seamless"], False))

# B1's rows on phase 20's paths: name -> (rows, d_model)
EMB_RMSNORM_SHAPES = {
    "internvl_prefill": (BATCH * (EMB_PREFIX + PROMPT), 2048),
    "internvl_decode": (BATCH, 2048),
    "internvl_train": (EMB_TBATCH * (EMB_PREFIX + PROMPT), 2048),
    "seamless_enc": (BATCH * EMB_FRAMES, 1024),
    "seamless_prefill": (BATCH * PROMPT, 1024),
    "seamless_decode": (BATCH, 1024),
    "seamless_train": (EMB_TBATCH * PROMPT, 1024),
    "seamless_enc_train": (EMB_TBATCH * EMB_FRAMES, 1024)}

# (memory B/s, bf16 tensor FLOP/s, fp32 FLOP/s), NVIDIA data sheets, dense
PEAKS = {"SXM": (3.35e12, 989e12, 67e12), "PCIe": (2.0e12, 756e12, 51e12),
         "NVL": (3.9e12, 835e12, 60e12)}


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


def sh(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, n_sets: int = 1, rounds: int = 10) -> float:
    """Device time of one ``fn(i)``: ``rounds`` passes over the input sets
    ``i < n_sets`` captured in one CUDA graph and replayed, timed with CUDA
    events, so no host work sits between the launches (an eager loop of a
    small kernel measures its wrapper's Python instead). With several
    independent sets whose sum exceeds the 50 MB L2, each call finds its
    inputs evicted by the other sets' traffic: cold, as the path finds
    them."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for i in range(n_sets):
            fn(i)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for i in range(n_sets):
                fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (rounds * n_sets)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(peaks, n_bytes: float, n_ops: float, dtype):
    mem, bf16, fp32 = peaks
    t_bytes = n_bytes / mem
    t_ops = n_ops / (bf16 if dtype == torch.bfloat16 else fp32)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def causal_pairs(Sq, Sk, causal, window) -> int:
    """Unmasked (query, key) pairs: the work this input needs."""
    total = 0
    for i in range(Sq):
        if not causal:
            total += Sk
            continue
        hi = min(i, Sk - 1)
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def rolling_pos(B, C, cur, device):
    """Per-slot positions of a rolling cache of capacity C after writing
    positions 0..cur (slot = position % C; -1 = never written)."""
    slots = torch.arange(C, device=device)
    base = cur - cur % C
    pos = torch.where(slots <= cur % C, base + slots, base - C + slots)
    pos = torch.where(pos < 0, torch.full_like(pos, -1), pos)
    return pos.to(torch.int32)[None].expand(B, C).contiguous()


# ---------------------------------------------------------------- phase 1
# the kernels this slice redesigned; their ptxas lines are printed and
# must show no spills
NEW_KERNELS = ("flash_wgmma_kernel", "decode_split_kernel", "combine_kernel",
               "paged_split_kernel", "paged_merge_kernel",
               "ssd_wgmma_kernel", "rmsnorm_vec_kernel",
               "rmsnorm_scalar_kernel", "flash_bwd_prep_kernel",
               "flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
               "flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel",
               "flash_bwd_dq_kernel",
               "rmsnorm_bwd_vec_kernel", "rmsnorm_bwd_scalar_kernel",
               "rmsnorm_dscale_sum_kernel")
# the kernels that must run on the tensor cores (HGMMA in their SASS)
HGMMA_KERNELS = ("flash_wgmma_kernel", "ssd_wgmma_kernel",
                 "flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel")


def ptxas_table(log: str) -> dict:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads"}}
    from ``nvcc -Xptxas -v`` output."""
    table, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            table.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            table[name].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            table[name]["registers"] = int(m.group(1))
    return table


def sass_hgmma(lib_path) -> dict:
    """{mangled kernel name: count of HGMMA instructions} in the built
    library's SASS (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or str(
        pathlib.Path(build.nvcc()).with_name("cuobjdump"))
    counts, name = {}, None
    for line in sh([tool, "-sass", str(lib_path)]).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and "HGMMA" in line:
            counts[name] += 1
    return counts


def check_build(path, log):
    """Phase 1's checks of the built library: the bf16 flash, flash
    backward and SSD-scan kernels run on the tensor cores (HGMMA in their
    SASS), and no kernel redesigned for Hopper spills registers."""
    hgmma = sass_hgmma(path)
    for kname in HGMMA_KERNELS:
        found = {k: v for k, v in hgmma.items() if kname in k}
        for k, v in found.items():
            print(f"  SASS {k}: {v} HGMMA")
        if not found or not all(found.values()):
            raise SystemExit(f"{kname} without HGMMA: {found}")
    tensor = {k: v for k, v in hgmma.items()
              if any(n in k for n in HGMMA_KERNELS)}
    # ptxas's performance remarks (C7515, C7520: wgmma serialized) would
    # mean the flash kernel's pipelining is lost; shown, not fatal
    for line in log.splitlines():
        if "Potential Performance Loss" in line:
            print(f"  {line.strip()[:200]}")
    table = {k: v for k, v in ptxas_table(log).items()
             if any(n in k for n in NEW_KERNELS)}
    for k, v in sorted(table.items()):
        print(f"  ptxas {k}: {v.get('registers')} registers, "
              f"{v.get('spill_stores')} B spill stores, "
              f"{v.get('spill_loads')} B spill loads")
    spills = [k for k, v in table.items()
              if v.get("spill_stores") or v.get("spill_loads")]
    if not table or spills:
        raise SystemExit(f"redesigned kernels spill (or ptxas printed "
                         f"nothing): {spills or table}")
    return {"hgmma": tensor, "ptxas": table}


# ---------------------------------------------------------------- phase 2
def _gqa_sdpa(q, k, v, **kw):
    """SDPA in [B, heads, S, D] layout with grouped KV heads (yardstick)."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), enable_gqa=True,
                                          **kw)


def _widths(D):
    """A case's head widths: D, or (D, Dv) where v's rows are narrower
    (MLA's (192, 128))."""
    return D if isinstance(D, tuple) else (D, D)


def check_flash(dev, peaks, g):
    H_, K_, D_ = MLA_HEADS
    cases = [  # (name, B, Sq, Sk, H, K, D or (D, Dv), causal, window, dtype)
        ("main", BATCH, PROMPT, PROMPT, 24, 8, 128, True, 0, torch.bfloat16),
        ("grpo_prefill", GROUPS, GPROMPT, GPROMPT, 24, 8, 128, True, 0,
         torch.bfloat16),
        ("ppo", PBATCH, PPROMPT + GEN, PPROMPT + GEN, 24, 8, 128, True, 0,
         torch.bfloat16),
        # the separate path's scoring and training: MHA (G = 1) at D 64
        ("sep_actor", SBATCH, SLEN, SLEN, 32, 32, 64, True, 0,
         torch.bfloat16),
        ("sep_critic", SBATCH, SLEN, SLEN, 16, 16, 64, True, 0,
         torch.bfloat16),
        ("sep_prefill", SBATCH, SPROMPT, SPROMPT, 32, 32, 64, True, 0,
         torch.bfloat16),
        ("ragged", 2, 100, 37, 24, 8, 128, False, 0, torch.bfloat16),
        ("ragged_causal", 2, 100, 37, 24, 8, 128, True, 0, torch.bfloat16),
        ("sq65_sk129", 2, 65, 129, 24, 8, 128, False, 0, torch.bfloat16),
        ("sq65_sk129_c", 2, 65, 129, 24, 8, 128, True, 0, torch.bfloat16),
        ("sk50_causal", 3, 50, 50, 24, 8, 128, True, 0, torch.bfloat16),
        ("window", 2, 256, 256, 24, 8, 128, True, 64, torch.bfloat16),
        ("window_cut", 2, 300, 300, 24, 8, 128, True, 100, torch.bfloat16),
        ("d64", 2, 192, 192, 8, 2, 64, True, 0, torch.bfloat16),
        ("d64_ragged", 2, 77, 77, 8, 2, 64, True, 40, torch.bfloat16),
        ("d64_full", 1, 129, 65, 4, 4, 64, False, 0, torch.bfloat16),
        ("fp32", 2, 130, 130, 6, 2, 128, True, 16, torch.float32),
        ("fp32_d64", 2, 100, 37, 4, 2, 64, False, 0, torch.float32),
        # each MTP draft: one layer at one position (phase 13's spec path,
        # and the cyclic-token bench's fp32 model)
        ("mtp_draft", BATCH, 1, 1, 24, 8, 128, True, 0, torch.bfloat16),
        ("cyc_mtp_draft", CYC_B, 1, 1, 2, 1, 64, True, 0, torch.float32),
        # a tensor-parallel rank's heads at ntp 2 (phase 16): llama3_2_3b's
        # 12 query and 4 KV heads, opt_1_3b's 16
        ("tp_llama", BATCH, PROMPT, PROMPT, 12, 4, 128, True, 0,
         torch.bfloat16),
        ("tp_opt", SBATCH, SLEN, SLEN, 16, 16, 64, True, 0, torch.bfloat16),
        # phase 17's serving prefills: granite G 3 at D 64, qwen G 1 and
        # jamba G 4 at D 128; and granite's separate PPO path (with lse)
        *[(fam, BATCH, PROMPT, PROMPT, H, K, D, True, 0, torch.bfloat16)
          for fam, (H, K, D) in FAMILY_HEADS.items()],
        ("granite_ppo", SBATCH, SLEN, SLEN, 24, 8, 64, True, 0,
         torch.bfloat16),
        # phase 18: deepseek's MLA prefill (serving) and its training
        # forward (with lse), q/k heads of 192 and v heads of 128, and edge
        # cases of the pair: windows, ragged Sq != Sk, fp32
        ("mla_serve", BATCH, PROMPT, PROMPT, H_, K_, D_, True, 0,
         torch.bfloat16),
        ("mla_train", DS_TBATCH, DS_TSEQ, DS_TSEQ, H_, K_, D_, True, 0,
         torch.bfloat16),
        ("mla_window", 1, 300, 300, 8, 8, D_, True, 100, torch.bfloat16),
        ("mla_ragged", 2, 65, 129, 8, 8, D_, False, 0, torch.bfloat16),
        ("mla_ragged_c", 2, 100, 37, 8, 8, D_, True, 0, torch.bfloat16),
        ("mla_fp32", 1, 130, 130, 4, 4, D_, True, 16, torch.float32),
        # phase 19: qwen1_5_110b (G 8) and command_r_plus_104b (G 12), the
        # serving prefill and a train step's microbatch (with lse)
        *[(m, BATCH, PROMPT, PROMPT, H, K, D, True, 0, torch.bfloat16)
          for m, (H, K, D) in BIG_HEADS.items()],
        *[(f"{m}_train", BIG_TBATCH // 2, BIG_TSEQ, BIG_TSEQ, H, K, D, True,
           0, torch.bfloat16) for m, (H, K, D) in BIG_HEADS.items()],
        ("g12_ragged", 2, 100, 37, 24, 2, 128, True, 0, torch.bfloat16),
        ("g12_fp32", 2, 130, 130, 12, 1, 64, True, 16, torch.float32),
        # phase 20's serving prefills: internvl's causal 256 + 512
        # positions; seamless's encoder self-attention (non-causal, 1024
        # frames) and its cross-attention (512 decoder queries over the
        # 1024 frames, non-causal), both MHA at D 64; B2 at one query over
        # the frames (a decode step's cross-attention; check_decode's
        # "seamless_xdec" times B3 at it for the record), and the train
        # steps' rows, each with lse
        *[(m, BATCH, Sq, Sk, H, K, D, causal, 0, torch.bfloat16)
          for m, Sq, Sk, (H, K, D), causal in EMB_B2_SHAPES],
        *[(f"{m}_train", EMB_TBATCH, Sq, Sk, H, K, D, causal, 0,
           torch.bfloat16)
          for m, Sq, Sk, (H, K, D), causal in EMB_B2_SHAPES[:3]],
        ("xattn_fp32", 2, 33, 70, 4, 4, 64, False, 0, torch.float32),
    ]
    big_steps = tuple(f"{m}_train" for m in BIG_HEADS)
    out = []
    g20 = torch.Generator(device=dev).manual_seed(PHASE20_SEED)
    for name, B, Sq, Sk, H, K, D, causal, window, dt in cases:
        D, Dv = _widths(D)
        gg = g20 if name.startswith(PHASE20_CASES) else g
        q = torch.randn(B, Sq, H, D, generator=gg, device=dev).to(dt)
        k = torch.randn(B, Sk, K, D, generator=gg, device=dev).to(dt)
        v = torch.randn(B, Sk, K, Dv, generator=gg, device=dev).to(dt)
        got = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        want, want_lse = ref.attention_ref(q, k, v, causal=causal,
                                           window=window, return_lse=True)
        # the lse output (the training path's) beside the same out
        got2, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                           window=window, return_lse=True)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        if not torch.equal(got, got2):
            raise SystemExit(f"flash {name}: out differs with return_lse")
        rec = {"case": name, "shape": [B, Sq, Sk, H, K, D], "causal": causal,
               "window": window, "dtype": str(dt),
               "max_err": max(err, lse_err), "out_err": err,
               "lse_err": lse_err, "tol": TOL[dt]}
        if Dv != D:
            rec["v_width"] = Dv
        if name == "main":
            rec["ms"] = time_ms(lambda: fa.flash_attention_fwd(
                q, k, v, causal=causal, window=window))
            rec["plain_ms"] = time_ms(lambda: ref.attention_ref(
                q, k, v, causal=causal, window=window), iters=5)
            rec["library_ms"] = time_ms(lambda: _gqa_sdpa(
                q, k, v, is_causal=causal))
            # device time (graph replay): warm on one set; cold over 3 sets
            # of 67 MB, each call's inputs evicted by the other sets' 134 MB
            # (one set alone exceeds the L2)
            sets = [[torch.randn_like(t) for t in (q, k, v)] for _ in range(3)]
            rec["device_ms"] = time_graph_ms(lambda i: fa.flash_attention_fwd(
                q, k, v, causal=causal, window=window))
            rec["cold_ms"] = time_graph_ms(lambda i: fa.flash_attention_fwd(
                *sets[i], causal=causal, window=window), len(sets))
            rec["library_cold_ms"] = time_graph_ms(lambda i: _gqa_sdpa(
                *sets[i], is_causal=causal), len(sets))
            del sets
            n_ops = 4 * B * H * D * causal_pairs(Sq, Sk, causal, window)
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(q, k, v, got), n_ops, dt)
        emb_serve = tuple(m for m, *_ in EMB_B2_SHAPES)
        if name in ("ppo", "sep_actor", "granite_ppo", "mla_serve",
                    "mla_train", *FAMILY_HEADS, *BIG_HEADS, *big_steps,
                    *emb_serve):
            # the training path's call, with the lse output (a serving
            # prefill's, without, for phase 17's families and phase 18's,
            # 19's and 20's serving): device time by graph replay, warm and
            # cold, beside SDPA's at this shape
            lse_out = name not in (*FAMILY_HEADS, "mla_serve", *BIG_HEADS,
                                   *emb_serve)

            def make_set():
                return [torch.randn_like(t) for t in (q, k, v)]
            rec["device_ms"], rec["cold_ms"] = time_graph_warm_cold(
                lambda *a: fa.flash_attention_fwd(
                    *a, causal=causal, window=window, return_lse=lse_out),
                make_set)
            rec["library_cold_ms"] = time_graph_warm_cold(
                lambda *a: _gqa_sdpa(*a, is_causal=causal), make_set)[1]
            # S = QK^T over D and PV over Dv, 2 flop a product term
            n_ops = 2 * B * H * (D + Dv) * causal_pairs(Sq, Sk, causal,
                                                         window)
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(q, k, v, got, *((lse,) if lse_out else ())),
                n_ops, dt)
        out.append(rec)
    return out


def check_decode(dev, peaks, g):
    cases = [  # (name, B, H, K, D, C, cur, window, dtype)
        ("main", BATCH, 24, 8, 128, PROMPT + GEN, PROMPT + GEN - 2, 0,
         torch.bfloat16),
        ("wrapped", 2, 24, 8, 128, 16, 19, 0, torch.bfloat16),
        ("window", 2, 24, 8, 128, 16, 19, 8, torch.bfloat16),
        # cur early: most slots masked, most of the 5 splits hold no valid
        # slot
        ("early", BATCH, 24, 8, 128, PROMPT + GEN, 40, 0, torch.bfloat16),
        ("c_lt_split", 2, 24, 8, 128, 20, 30, 0, torch.bfloat16),
        ("g1", 2, 8, 8, 128, 300, 250, 0, torch.bfloat16),
        ("g8", 2, 16, 2, 128, 300, 250, 64, torch.bfloat16),
        # row 1 has no valid slot: the uniform mean over its C slots
        ("masked_row", 4, 24, 8, 128, PROMPT + GEN, 500, 0, torch.bfloat16),
        ("d64", 2, 8, 2, 64, 100, 70, 0, torch.bfloat16),
        # the separate path's rollout (opt_1_3b, MHA at D 64), its last step
        ("sep", SBATCH, 32, 32, 64, SLEN, SLEN - 2, 0, torch.bfloat16),
        ("fp32", 2, 6, 1, 128, 200, 150, 32, torch.float32),
        ("fp32_g8_d64", 3, 16, 2, 64, 333, 400, 0, torch.float32),
        # a tensor-parallel rank's heads at ntp 2 (phase 16): the batcher's
        # llama3_2_3b step (4 slots over 640) and the OPT rollout's last
        ("tp_llama", 4, 12, 4, 128, 640, 600, 0, torch.bfloat16),
        ("tp_opt", SBATCH, 16, 16, 64, SLEN, SLEN - 2, 0, torch.bfloat16),
        # phase 17's serving decode steps, their last: the three families'
        # head layouts over 576 slots
        *[(fam, BATCH, H, K, D, PROMPT + GEN, PROMPT + GEN - 2, 0,
           torch.bfloat16) for fam, (H, K, D) in FAMILY_HEADS.items()],
        # phase 19's serving decode steps, their last: qwen1_5_110b (G 8)
        # and command_r_plus_104b (G 12: two blocks of 6 heads a KV head);
        # G 12 and 16 in both dtypes and head dims, a window, a masked row
        *[(m, BATCH, H, K, D, PROMPT + GEN, PROMPT + GEN - 2, 0,
           torch.bfloat16) for m, (H, K, D) in BIG_HEADS.items()],
        ("g12_d64", 3, 24, 2, 64, 300, 420, 96, torch.bfloat16),
        ("g12_fp32", 3, 24, 2, 128, 300, 420, 0, torch.float32),
        ("g12_fp32_d64", 2, 12, 1, 64, 200, 150, 32, torch.float32),
        ("g16", 2, 32, 2, 128, 300, 250, 64, torch.bfloat16),
        ("g12_masked_row", 4, 96, 8, 128, PROMPT + GEN, 500, 0,
         torch.bfloat16),
        # phase 20's decode steps, their last: internvl's self-attention
        # over 256 + 512 + 64 slots; and B3 at seamless's cross-attention
        # shape, the 1024 frames all valid (positions 0..1023, the query's
        # 1023), MHA at D 64: the path sends it to B2 at one query
        # ("seamless_xdec_q1" in check_flash), faster cold; this keeps the
        # comparison on record
        ("internvl", BATCH, *EMB_HEADS["internvl"], EMB_PREFIX + PROMPT + GEN,
         EMB_PREFIX + PROMPT + GEN - 2, 0, torch.bfloat16),
        ("seamless_xdec", BATCH, *EMB_HEADS["seamless"], EMB_FRAMES,
         EMB_FRAMES - 1, 0, torch.bfloat16),
    ]
    out = []
    g20 = torch.Generator(device=dev).manual_seed(PHASE20_SEED)
    for name, B, H, K, D, C, cur, window, dt in cases:
        gg = g20 if name.startswith(PHASE20_CASES) else g
        q = torch.randn(B, H, D, generator=gg, device=dev).to(dt)
        kc = torch.randn(B, C, K, D, generator=gg, device=dev).to(dt)
        vc = torch.randn(B, C, K, D, generator=gg, device=dev).to(dt)
        pos = rolling_pos(B, C, cur, dev)
        position = torch.full((B,), cur, dtype=torch.int32, device=dev)
        if name.endswith("masked_row"):
            position[1] = -1
        got = dec.decode_attention(q, kc, vc, pos, position, window=window)
        want = ref.decode_attention_ref(q, kc, vc, pos, position,
                                        window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rec = {"case": name, "shape": [B, H, K, D, C], "cur": cur,
               "window": window, "dtype": str(dt), "max_err": err,
               "tol": (TOL_GROUP if H // K > 8 else TOL)[dt],
               "splits": dec.split_plan(B, K, C)[0]}
        if name == "main":
            valid = (pos >= 0) & (pos <= position[:, None])
            mask = valid[:, None, None, :]
            rec["ms"] = time_ms(lambda: dec.decode_attention(
                q, kc, vc, pos, position, window=window))
            rec["plain_ms"] = time_ms(lambda: ref.decode_attention_ref(
                q, kc, vc, pos, position, window=window))
            rec["library_ms"] = time_ms(lambda: _gqa_sdpa(
                q[:, None], kc, vc, attn_mask=mask))
            # cold, as the path finds it (28 layers' caches a step): 6
            # independent 18.9 MB caches, 113 MB, rotated
            sets = [(torch.randn_like(q), torch.randn_like(kc),
                     torch.randn_like(vc)) for _ in range(6)]
            rec["device_ms"] = time_graph_ms(lambda i: dec.decode_attention(
                q, kc, vc, pos, position, window=window))
            rec["cold_ms"] = time_graph_ms(lambda i: dec.decode_attention(
                *sets[i], pos, position, window=window), len(sets))
            rec["library_cold_ms"] = time_graph_ms(lambda i: _gqa_sdpa(
                sets[i][0][:, None], sets[i][1], sets[i][2], attn_mask=mask),
                len(sets))
            del sets
            n_ops = 4 * H * D * int(valid.sum().item())
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(q, kc, vc, pos, position, got), n_ops, dt)
        if name in ("sep", *FAMILY_HEADS, *BIG_HEADS, "internvl",
                    "seamless_xdec"):
            valid = (pos >= 0) & (pos <= position[:, None])
            mask = valid[:, None, None, :]

            def make_set():
                return [torch.randn_like(t) for t in (q, kc, vc)]
            rec["device_ms"], rec["cold_ms"] = time_graph_warm_cold(
                lambda qq, kk, vv: dec.decode_attention(
                    qq, kk, vv, pos, position, window=window), make_set)
            rec["library_cold_ms"] = time_graph_warm_cold(
                lambda qq, kk, vv: _gqa_sdpa(qq[:, None], kk, vv,
                                             attn_mask=mask), make_set)[1]
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(q, kc, vc, pos, position, got),
                4 * H * D * int(valid.sum().item()), dt)
        out.append(rec)
    return out


def cold_sets(set_bytes: int) -> int:
    """Input sets for a cold timing: together at least twice the 50 MB L2,
    so each call finds its inputs evicted (at least 3, at most 2048)."""
    return max(3, min(2048, -(-100 * 2**20 // set_bytes)))


def time_graph_warm_cold(fn, make_set):
    """(warm, cold) device ms of ``fn(*inputs)`` by CUDA-graph replay: warm
    on one set of inputs, cold rotating over ``cold_sets`` fresh sets from
    ``make_set()``."""
    first = make_set()
    warm = time_graph_ms(lambda i: fn(*first))
    n = cold_sets(nbytes(*first))
    sets = [first] + [make_set() for _ in range(n - 1)]
    rounds = max(1, 2000 // n)
    cold = time_graph_ms(lambda i: fn(*sets[i]), n, rounds=rounds)
    return warm, cold


# every shape the three paths give B1: (rows, width)
RMSNORM_PATH_SHAPES = {
    "main": (BATCH * PROMPT, 3072), "decode": (BATCH, 3072),
    "grpo_prefill": (GROUPS * GPROMPT, 3072),
    "grpo_decode": (GROUPS * GSIZE, 3072),
    # the PPO path's scoring and training forwards and their recompute
    # (its rollout gives the main and decode shapes)
    "ppo_prefill": (PBATCH * (PPROMPT + GEN), 3072),
    # the Mamba2 path: norm1 at d_model, the gated norm at d_inner
    "mamba_prefill": (MBATCH * MPROMPT, 1024),
    "mamba_gated": (MBATCH * MPROMPT, 2048),
    "mamba_decode": (MBATCH, 2048),
    # the separate path: opt_1_3b's and opt_350m's scoring and training
    # forwards, and the rollout's decode step
    "sep_actor": (SBATCH * SLEN, 2048), "sep_critic": (SBATCH * SLEN, 1024),
    "sep_decode": (SBATCH, 2048),
    # the speculative verify: k + 1 tokens a row
    "spec_verify": (BATCH * (SPEC_K + 1), 3072),
    # phase 17: each family's serving prefill and decode step at its
    # d_model (the MoE layers' norm2 too), jamba's gated norm at d_inner,
    # granite's paged GRPO request and its separate PPO iteration's
    # scoring and training forwards (actor and critic both at 1536)
    **{f"{fam}_{kind}": (rows, d) for fam, d in FAMILY_WIDTHS.items()
       for kind, rows in (("prefill", BATCH * PROMPT), ("decode", BATCH))},
    "jamba_gated": (BATCH * PROMPT, JAMBA_D_INNER),
    "jamba_gated_decode": (BATCH, JAMBA_D_INNER),
    "granite_grpo_prefill": (GROUPS * GPROMPT, FAMILY_WIDTHS["granite"]),
    "granite_grpo_decode": (GROUPS * GSIZE, FAMILY_WIDTHS["granite"]),
    "granite_ppo": (SBATCH * SLEN, FAMILY_WIDTHS["granite"]),
    # phase 18: deepseek's serving prefill and decode step at d_model 7168
    # (its scalar route), its MLA's q_norm (1536) and kv_norm (512), and
    # the train step's rows at each
    **{f"ds_{w}_{kind}": (rows, d) for w, d in DS_WIDTHS.items()
       for kind, rows in (("prefill", BATCH * PROMPT), ("decode", BATCH),
                          ("train", DS_TBATCH * DS_TSEQ))},
    # phase 19: qwen1_5_110b's 8192 and command_r_plus_104b's 12288 (both
    # the scalar route) at the serving prefill, a decode step and a train
    # step's microbatch of 2 x 256
    **{f"{m}_{kind}": (rows, d) for m, d in BIG_WIDTHS.items()
       for kind, rows in (("prefill", BATCH * PROMPT), ("decode", BATCH),
                          ("train", BIG_TBATCH // 2 * BIG_TSEQ))},
    # phase 20: internvl's prefill over 256 + 512 positions, its decode
    # step and its train step's rows at 2048; seamless's encoder over the
    # 1024 frames, its decoder's prefill, decode step and train rows, and
    # the encoder's train rows, at 1024
    **EMB_RMSNORM_SHAPES}


def check_rmsnorm(dev, peaks, g):
    """B1 at every path shape, timed by CUDA-graph replay warm and cold
    against ``F.rms_norm`` (the eager ``ms`` of the main and decode shapes
    is kept for continuity), and at each route of its plan."""
    bf = torch.bfloat16
    cases = [(name, shape, bf, bf) for name, shape in
             RMSNORM_PATH_SHAPES.items()] + [
        ("fp32", (3, 100), torch.float32, torch.float32),
        ("fp32_scale", (7, 384), bf, torch.float32),      # scalar route
        ("rows13", (13, 3072), bf, bf),     # a block of 5 of its 8 warps
        ("d100_bf16", (5, 100), bf, bf),    # 200-byte rows: scalar route
        ("wide", (2, 8192), bf, bf),        # too wide for registers: scalar
        # the cyclic-token bench's verify (fp32, d_model 128)
        ("cyc_verify", (CYC_B * (CYC_K + 1), 128), torch.float32,
         torch.float32),
    ]
    out = []
    for name, shape, dt, sdt in cases:
        x = torch.randn(*shape, generator=g, device=dev).to(dt)
        s = (1 + 0.1 * torch.randn(shape[-1], generator=g, device=dev)).to(sdt)
        got = rn.rmsnorm(x, s, 1e-5)
        want = ref.rmsnorm_ref(x, s, 1e-5)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        plan = rn.plan(shape[0], shape[1], dt, sdt)
        rec = {"case": name, "shape": list(shape), "dtype": str(dt),
               "max_err": err, "tol": TOL[dt], "route": plan.route,
               "per_lane": plan.per_lane, "warps": plan.warps}
        if name in RMSNORM_PATH_SHAPES:
            D = shape[-1]

            def make_set():
                return (torch.randn(*shape, device=dev).to(dt), s)
            rec["device_ms"], rec["cold_ms"] = time_graph_warm_cold(
                lambda xx, ss: rn.rmsnorm(xx, ss, 1e-5), make_set)
            rec["library_device_ms"], rec["library_cold_ms"] = \
                time_graph_warm_cold(
                    lambda xx, ss: F.rms_norm(xx, (D,), ss, 1e-5), make_set)
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(x, s, got), 4 * x.numel(), dt)
        if name in ("main", "decode"):
            rec["ms"] = time_ms(lambda: rn.rmsnorm(x, s, 1e-5), iters=50)
            rec["plain_ms"] = time_ms(lambda: ref.rmsnorm_ref(x, s, 1e-5))
            rec["library_ms"] = time_ms(lambda: F.rms_norm(
                x, (shape[-1],), s, 1e-5), iters=50)
        out.append(rec)
    return out


def scaled_err(got, want) -> float:
    """max |got - want| / max(1, max |want|): gradients grow past 1, and a
    bf16 output rounds to a step relative to its size."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item() / max(1.0,
                                                 want.abs().max().item())


def _sdpa_fwd_bwd(q, k, v, dout, causal, backward=True):
    """SDPA (GQA) on [B, S, heads, D] inputs and, with ``backward``, its
    backward through autograd: the yardstick, captured whole in a graph."""
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    o = _gqa_sdpa(qq, kk, vv, is_causal=causal)
    if backward:
        torch.autograd.grad(o, (qq, kk, vv), dout.transpose(1, 2))


def check_flash_bwd(dev, peaks, g):
    """B2-bwd against flash_attention_bwd_ref on the saved out and lse of
    B2's forward: at the PPO training shape (bf16 and fp32) and at D 64,
    G 1 and 8, windows of 100 that cut tiles, ragged S = 100, causal with
    Sk above and below Sq, and full (non-causal) ragged Sq != Sk in both
    dtypes, so the tensor-core route sees every mask; and at the separate
    paths' training shapes (the OPT pair's MHA and granite's G 3, both at
    D 64). The main shape is
    timed: eager and by graph replay (warm, cold), beside the plain
    version and SDPA's backward (GQA), eager through autograd and by graph
    replay as its forward + backward less its forward."""
    S = PPROMPT + GEN
    bf, f32 = torch.bfloat16, torch.float32
    H_, K_, D_ = MLA_HEADS
    cases = [  # (name, B, Sq, Sk, H, K, D or (D, Dv), causal, window, dtype)
        ("main", PBATCH, S, S, 24, 8, 128, True, 0, bf),
        ("fp32", PBATCH, S, S, 24, 8, 128, True, 0, f32),
        # the separate path's training: MHA (G = 1) at D 64
        ("sep_actor", SBATCH, SLEN, SLEN, 32, 32, 64, True, 0, bf),
        ("sep_critic", SBATCH, SLEN, SLEN, 16, 16, 64, True, 0, bf),
        # granite's separate PPO training (phase 17): G 3 at D 64
        ("granite_ppo", SBATCH, SLEN, SLEN, 24, 8, 64, True, 0, bf),
        ("d64", 2, 192, 192, 8, 2, 64, True, 0, bf),
        ("g1", 2, 192, 192, 8, 8, 64, True, 0, bf),
        ("g8", 1, 160, 160, 16, 2, 128, True, 0, bf),
        ("window", 1, 300, 300, 6, 2, 128, True, 100, bf),
        ("window_d64", 2, 200, 200, 4, 2, 64, True, 100, bf),
        ("ragged", 2, 100, 100, 6, 2, 128, True, 0, bf),
        ("sk_gt_sq", 2, 37, 100, 6, 2, 128, True, 0, bf),
        ("sq_gt_sk", 2, 100, 37, 6, 2, 128, True, 0, bf),
        ("full_ragged_bf16", 2, 65, 129, 4, 2, 64, False, 0, bf),
        ("full_ragged_d128", 2, 129, 65, 6, 2, 128, False, 0, bf),
        ("ragged_fp32", 2, 100, 100, 6, 2, 64, True, 0, f32),
        ("full_ragged", 2, 65, 129, 4, 2, 64, False, 0, f32),
        # phase 18's MLA training shape (the CUDA-core route, bf16 loads
        # and fp32 products) and the pair's edge cases
        ("mla_train", DS_TBATCH, DS_TSEQ, DS_TSEQ, H_, K_, D_, True, 0, bf),
        ("mla_window", 1, 300, 300, 4, 4, D_, True, 100, bf),
        ("mla_ragged", 2, 65, 129, 4, 4, D_, False, 0, bf),
        ("mla_sq_gt_sk", 2, 100, 37, 4, 4, D_, True, 0, bf),
        ("mla_fp32", 1, 130, 130, 4, 4, D_, True, 0, f32),
        # phase 19's train steps: a microbatch of 2 x 256 at qwen1_5_110b's
        # G 8 and command_r_plus_104b's G 12
        *[(f"{m}_train", BIG_TBATCH // 2, BIG_TSEQ, BIG_TSEQ, H, K, D, True,
           0, bf) for m, (H, K, D) in BIG_HEADS.items()],
        # phase 20's train steps: internvl's causal 256 + 512 positions,
        # seamless's encoder (non-causal over 1024 frames) and its
        # cross-attention (512 queries over 1024 frames, non-causal, the
        # frames' K/V gradients); Sq != Sk non-causal at G 1, D 64 in fp32
        *[(f"{m}_train", EMB_TBATCH, Sq, Sk, H, K, D, causal, 0, bf)
          for m, Sq, Sk, (H, K, D), causal in EMB_B2_SHAPES[:3]],
        ("xattn_fp32", 2, 33, 70, 4, 4, 64, False, 0, f32),
    ]
    out_recs = []
    g20 = torch.Generator(device=dev).manual_seed(PHASE20_SEED)
    for name, B, Sq, Sk, H, K, D, causal, window, dt in cases:
        D, Dv = _widths(D)
        gg = g20 if name.startswith(PHASE20_CASES) else g
        q = torch.randn(B, Sq, H, D, generator=gg, device=dev).to(dt)
        k = torch.randn(B, Sk, K, D, generator=gg, device=dev).to(dt)
        v = torch.randn(B, Sk, K, Dv, generator=gg, device=dev).to(dt)
        dout = torch.randn(B, Sq, H, Dv, generator=gg, device=dev).to(dt)
        kw = dict(causal=causal, window=window)
        out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        got = fab.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        rec = {"case": name, "shape": [B, Sq, Sk, H, K, D], "causal": causal,
               "window": window, "dtype": str(dt),
               "route": fab.route(dt, D, Dv),
               "max_err": max(scaled_err(a, b) for a, b in zip(got, want)),
               "max_abs_err": max((a.float() - b.float()).abs().max().item()
                                  for a, b in zip(got, want)),
               "tol": TOL[dt]}
        if Dv != D:
            rec["v_width"] = Dv
        del want
        if name == "main":
            rec["ms"] = time_ms(lambda: fab.flash_attention_bwd(
                q, k, v, out, lse, dout, **kw), iters=10)
            rec["plain_ms"] = time_ms(lambda: ref.flash_attention_bwd_ref(
                q, k, v, out, lse, dout, **kw), iters=2, warmup=1)
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            oo = _gqa_sdpa(qq, kk, vv, is_causal=causal)
            do_t = dout.transpose(1, 2)
            rec["library_ms"] = time_ms(lambda: torch.autograd.grad(
                oo, (qq, kk, vv), do_t, retain_graph=True), iters=10)
            del qq, kk, vv, oo
        if name in ("main", "sep_actor", "granite_ppo", "mla_train",
                    *(f"{m}_train" for m in BIG_HEADS),
                    "seamless_enc_train", "seamless_cross_train"):
            def make_set():
                qs, ks, vs, ds = (torch.randn_like(t) for t in (q, k, v, dout))
                os_, ls = fa.flash_attention_fwd(qs, ks, vs, return_lse=True,
                                                 **kw)
                return qs, ks, vs, os_, ls, ds
            rec["device_ms"], rec["cold_ms"] = time_graph_warm_cold(
                lambda *a: fab.flash_attention_bwd(*a, **kw), make_set)
            both = time_graph_warm_cold(
                lambda qs, ks, vs, os_, ls, ds: _sdpa_fwd_bwd(
                    qs, ks, vs, ds, causal), make_set)
            fwd = time_graph_warm_cold(
                lambda qs, ks, vs, os_, ls, ds: _sdpa_fwd_bwd(
                    qs, ks, vs, ds, causal, backward=False), make_set)
            rec["library_device_ms"] = both[0] - fwd[0]
            rec["library_cold_ms"] = both[1] - fwd[1]
            rec["library_fwd_bwd_cold_ms"] = both[1]
            # S and dK, dQ over D; dP and dV over Dv
            n_ops = 2 * (3 * D + 2 * Dv) * B * H * causal_pairs(
                Sq, Sk, causal, window)
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(q, k, v, out, lse, dout, *got), n_ops, dt)
        out_recs.append(rec)
    return out_recs


def check_rmsnorm_bwd(dev, peaks, g):
    """B1-bwd (dx and dscale) against rmsnorm_bwd_ref at the training
    path's rows ([8 x 576, 3072]), a decode step's rows, a row count that
    does not split evenly over the blocks and at each route of the plan;
    dx the same bits without dscale, dscale the same bits in a second
    call; the main shape timed without dscale (the hydra path's: the
    trunk is frozen) and with it, beside the backward of F.rms_norm with
    respect to x; the separate paths' widths ([8 x 512, 2048] and
    [8 x 512, 1024] of the OPT pair, [8 x 512, 1536] of granite, phase
    19's and 20's train rows, where every scale trains) timed with dscale
    beside
    F.rms_norm's backward with the weight's gradient; each library time
    by graph replay as its forward and backward less its forward."""
    bf = torch.bfloat16
    cases = [("main", (PBATCH * (PPROMPT + GEN), 3072), bf, bf),
             ("sep_actor", (SBATCH * SLEN, 2048), bf, bf),
             ("sep_critic", (SBATCH * SLEN, 1024), bf, bf),
             # granite's separate PPO (phase 17), every scale trains
             ("granite_ppo", RMSNORM_PATH_SHAPES["granite_ppo"], bf, bf),
             # deepseek's train step (phase 18): d_model (the scalar
             # route), q_norm and kv_norm widths, every scale trains
             *[(f"sep_ds_{w}", (DS_TBATCH * DS_TSEQ, d), bf, bf)
               for w, d in DS_WIDTHS.items()],
             # phase 19's train steps (a microbatch of 2 x 256) at
             # qwen1_5_110b's 8192 and command_r_plus_104b's 12288, and
             # both widths at 4096 and 8 rows
             *[(f"sep_{m}{tag}", (rows, d), bf, bf)
               for m, d in BIG_WIDTHS.items()
               for tag, rows in (("", BIG_TBATCH // 2 * BIG_TSEQ),
                                 ("_4096", BATCH * PROMPT), ("_8", 8))],
             # phase 20's train steps: internvl's rows at 2048, seamless's
             # decoder's and encoder's at 1024, every scale trains
             *[(f"sep_{m}", EMB_RMSNORM_SHAPES[m], bf, bf)
               for m in ("internvl_train", "seamless_train",
                         "seamless_enc_train")],
             ("uneven", (SBATCH * SLEN + 1, 2048), bf, bf),
             ("rows8", (8, 3072), bf, bf),
             ("fp32", (3, 100), torch.float32, torch.float32),
             ("fp32_scale", (7, 384), bf, torch.float32),   # scalar route
             ("d100_bf16", (5, 100), bf, bf),               # scalar route
             ("wide", (2, 8192), bf, bf),                   # scalar route
             ("fp32_rows", (2048, 512), torch.float32, torch.float32)]
    out = []
    for name, shape, dt, sdt in cases:
        x = torch.randn(*shape, generator=g, device=dev).to(dt)
        dy = torch.randn(*shape, generator=g, device=dev).to(dt)
        s = (1 + 0.1 * torch.randn(shape[-1], generator=g, device=dev)).to(sdt)
        dx, ds = rn.rmsnorm_bwd(x, s, dy, 1e-5)
        want_dx, want_ds = ref.rmsnorm_bwd_ref(x, s, dy, 1e-5)
        dx2, _ = rn.rmsnorm_bwd(x, s, dy, 1e-5, dscale=False)
        _, ds2 = rn.rmsnorm_bwd(x, s, dy, 1e-5)
        torch.cuda.synchronize()
        if not torch.equal(dx, dx2):
            raise SystemExit(f"rmsnorm_bwd {name}: dx differs without dscale")
        if not torch.equal(ds, ds2):
            raise SystemExit(f"rmsnorm_bwd {name}: dscale differs between "
                             f"two calls")
        pl = rn.bwd_plan(shape[0], shape[1], dt, sdt)
        rec = {"case": name, "shape": list(shape), "dtype": str(dt),
               "max_err": max(scaled_err(dx, want_dx),
                              scaled_err(ds, want_ds)),
               "max_abs_err": max((dx.float() - want_dx.float()).abs().max()
                                  .item(), (ds.float() - want_ds.float())
                                  .abs().max().item()),
               "tol": TOL_RMS_BWD[dt], "route": pl.route,
               "blocks": pl.blocks, "warps": pl.warps}
        if name == "main":
            D = shape[-1]
            rec["ms"] = time_ms(lambda: rn.rmsnorm_bwd(x, s, dy, 1e-5,
                                                       dscale=False), iters=50)
            rec["plain_ms"] = time_ms(lambda: ref.rmsnorm_bwd_ref(x, s, dy))
            xr = x.detach().requires_grad_()
            yy = F.rms_norm(xr, (D,), s, 1e-5)
            rec["library_ms"] = time_ms(lambda: torch.autograd.grad(
                yy, xr, dy, retain_graph=True), iters=50)
            del xr, yy

            def make_set():
                return (torch.randn(*shape, device=dev).to(dt), s,
                        torch.randn(*shape, device=dev).to(dt))
            rec["device_ms"], rec["cold_ms"] = time_graph_warm_cold(
                lambda xx, ss, gg: rn.rmsnorm_bwd(xx, ss, gg, 1e-5,
                                                  dscale=False), make_set)
            rec["dscale_device_ms"], rec["dscale_cold_ms"] = \
                time_graph_warm_cold(
                    lambda xx, ss, gg: rn.rmsnorm_bwd(xx, ss, gg, 1e-5),
                    make_set)
            both, fwd = (time_graph_warm_cold(
                lambda xx, ss, gg, b=b: _rms_fwd_bwd(
                    xx, ss, gg, backward=b, dscale=False), make_set)
                for b in (True, False))
            rec["library_device_ms"] = both[0] - fwd[0]
            rec["library_cold_ms"] = both[1] - fwd[1]
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(x, s, dy, dx), 8 * x.numel(), dt)
        # the 4096- and 8-row cases at 8192 and 12288 are held against the
        # plain version and no longer timed (their last times: PERF.md §6)
        if (name.startswith("sep") or name == "granite_ppo") and \
                not name.endswith(("_4096", "_8")):
            def make_set():
                return (torch.randn(*shape, device=dev).to(dt), s,
                        torch.randn(*shape, device=dev).to(dt))
            rec["device_ms"], rec["cold_ms"] = time_graph_warm_cold(
                lambda xx, ss, gg: rn.rmsnorm_bwd(xx, ss, gg, 1e-5),
                make_set)
            both = time_graph_warm_cold(_rms_fwd_bwd, make_set)
            fwd = time_graph_warm_cold(
                lambda xx, ss, gg: _rms_fwd_bwd(xx, ss, gg, backward=False),
                make_set)
            rec["library_device_ms"] = both[0] - fwd[0]
            rec["library_cold_ms"] = both[1] - fwd[1]
            # dx's 8 operations an element, dscale's product and sum
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(x, s, dy, dx, ds), 10 * x.numel(), dt)
        out.append(rec)
    return out


def _rms_fwd_bwd(x, s, dy, backward=True, dscale=True):
    """F.rms_norm and, with ``backward``, its backward through autograd,
    with the weight's gradient when ``dscale``: the yardstick, captured
    whole in a graph."""
    xx, ss = x.detach().requires_grad_(), s.detach().requires_grad_(dscale)
    y = F.rms_norm(xx, (x.shape[-1],), ss, 1e-5)
    if backward:
        torch.autograd.grad(y, (xx, ss) if dscale else (xx,), dy)


def ssd_ops(B, S, H, P, N, chunk) -> int:
    """Operations the chunked scan needs: per (batch, chunk) of l steps the
    causal half of C B^T (2 N per pair j <= i; it does not depend on the
    head), and per (batch, head, chunk) the causal product with x (2 P per
    pair), y_off and the state update (2 x 2 l N P)."""
    l, nc = chunk, S // chunk
    pairs = l * (l + 1) // 2
    return B * nc * (2 * N * pairs + H * (2 * P * pairs + 4 * l * N * P))


def _ssd_inputs(B, S, H, P, N, dt, adt, decay, g, dev, sliced=False):
    """x, a, b, c for B5; with ``sliced``, b and c are column slices of one
    [B, S, H*P + 2N] tensor, as the Mamba2 block passes them (xbc)."""
    x = (0.5 * torch.randn(B, S, H, P, generator=g, device=dev)).to(dt)
    a = (-decay * torch.randn(B, S, H, generator=g, device=dev).abs()
         ).to(adt)
    if sliced:
        bc = (torch.randn(B, S, H * P + 2 * N, generator=g, device=dev)
              * N ** -0.25).to(dt)
        return x, a, bc[..., H * P:H * P + N], bc[..., H * P + N:]
    b = (torch.randn(B, S, N, generator=g, device=dev) * N ** -0.25).to(dt)
    c = (torch.randn(B, S, N, generator=g, device=dev) * N ** -0.25).to(dt)
    return x, a, b, c


def check_ssd(dev, peaks, g):
    """B5 against its plain version on fp32 copies of the inputs (the plain
    version of the model path rounds L and the states to x's dtype; the
    kernel keeps the state in fp32). b and c are scaled by N^-1/4 so a
    score C B^T has unit variance and |y| stays well below 16, where a
    bf16 output's own rounding (half an ulp, 0.0625) would exceed 5e-2.
    The main case is also timed by CUDA-graph replay, warm and cold."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # (name, B, S, H, P, N, chunk, dtype, a dtype, decay, sliced)
        ("main", MBATCH, MPROMPT, 32, 64, 128, 256, bf, f32, 0.3, True),
        ("contiguous", MBATCH, MPROMPT, 32, 64, 128, 256, bf, f32, 0.3,
         False),
        ("fp32", 2, 512, 8, 64, 128, 256, f32, f32, 0.3, False),
        ("one_chunk", 4, 256, 32, 64, 128, 256, bf, f32, 0.3, False),
        ("p32_n16", 2, 256, 16, 32, 16, 32, bf, bf, 0.3, False),
        ("p16_n8", 2, 128, 4, 16, 8, 16, f32, f32, 0.3, False),
        ("decay", 2, 1024, 8, 64, 128, 256, bf, f32, 4.0, False),
        ("sequential", 1, 128, 4, 64, 128, 64, f32, f32, 0.3, False),
        ("n64_c64", 2, 512, 4, 64, 64, 64, bf, f32, 0.3, False),
        ("n64_c128", 2, 512, 4, 64, 64, 128, bf, f32, 4.0, True),
        ("a_bf16", 2, 512, 8, 64, 128, 128, bf, bf, 0.3, False),
        ("chunk512", 1, 1024, 2, 64, 128, 512, bf, f32, 0.3, True),
        ("fp32_sliced", 2, 256, 4, 64, 128, 64, f32, f32, 0.3, True),
        # jamba's Mamba layers in phase 17's serving prefill: d_inner 8192
        # in 128 heads of 64, d_state 16 (the CUDA-core route), chunk 256
        ("jamba", BATCH, PROMPT, 128, 64, 16, 256, bf, f32, 0.3, True),
    ]
    out = []
    for name, B, S, H, P, N, chunk, dt, adt, decay, sliced in cases:
        x, a, b, c = _ssd_inputs(B, S, H, P, N, dt, adt, decay, g, dev,
                                 sliced)
        y, fin = ssd.ssd_scan(x, a, b, c, chunk)
        f32s = [t.float() for t in (x, a, b, c)]
        if name == "sequential":
            want = ref.ssd_sequential_ref(*f32s)
        else:
            want = ref.ssd_scan_ref(*f32s, chunk)
        torch.cuda.synchronize()
        err = max((got.float() - w).abs().max().item()
                  for got, w in zip((y, fin), want))
        rec = {"case": name, "shape": [B, S, H, P, N], "chunk": chunk,
               "dtype": str(dt), "a_dtype": str(adt), "decay": decay,
               "sliced": sliced, "route": ssd.route(P, N, chunk, dt),
               "max_err": err, "tol": TOL_SSD[dt],
               "max_abs_y": y.float().abs().max().item()}
        if name == "main":
            rec["ms"] = time_ms(lambda: ssd.ssd_scan(x, a, b, c, chunk),
                                iters=10)
            rec["plain_ms"] = time_ms(lambda: ref.ssd_scan_ref(
                x, a, b, c, chunk), iters=5)
            rec["library_ms"] = None      # no one PyTorch call computes it
            rec["device_ms"], rec["cold_ms"] = time_graph_warm_cold(
                lambda *t: ssd.ssd_scan(*t, chunk),
                lambda: _ssd_inputs(B, S, H, P, N, dt, adt, decay, g, dev,
                                    sliced))
            rec["library_cold_ms"] = None
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(x, a, b, c, y, fin),
                ssd_ops(B, S, H, P, N, chunk), dt)
        if name == "jamba":
            rec["device_ms"], rec["cold_ms"] = time_graph_warm_cold(
                lambda *t: ssd.ssd_scan(*t, chunk),
                lambda: _ssd_inputs(B, S, H, P, N, dt, adt, decay, g, dev,
                                    sliced))
            rec["library_cold_ms"] = None      # no one PyTorch call
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(x, a, b, c, y, fin),
                ssd_ops(B, S, H, P, N, chunk), dt)
        out.append(rec)
    return out


def forked_tables(B, P, G, gen, ps):
    """The paged GRPO rollout's block tables at its last decode step:
    B prompts of P tokens, each forked into G rows that each appended
    gen - 1 tokens (``Rollout._generate_paged``'s page manager)."""
    nb = -(-(P + gen) // ps)
    pm = PageManager(B * (-(-P // ps)) + B * G * (nb - P // ps), ps)
    for b in range(B):
        pm.allocate(b * G, P)
        for g in range(1, G):
            pm.fork(b * G, b * G + g)
    for _ in range(gen - 1):
        for s in range(B * G):
            pm.append_token(s)
    return torch.from_numpy(pm.block_table_array(range(B * G), nb)), \
        pm.num_pages


def holey_tables(B, nb, ps, P, g):
    """Random distinct pages with -1 holes in the middle and at the end,
    rows 2i and 2i+1 sharing their first pages, a partial last page and an
    idle row (position -1)."""
    bt = torch.randperm(P, generator=g)[:B * nb].reshape(B, nb).int()
    for i in range(0, B - 1, 2):
        bt[i + 1, :nb // 2] = bt[i, :nb // 2]
    bt[0, 1] = -1
    bt[1, -1] = -1
    position = torch.randint(0, (nb - 1) * ps, (B,), generator=g)
    position[2] = nb * ps - 3
    position[-1] = -1
    return bt, position.int()


def paged_work(bt, position, ps, K, D, H, itemsize):
    """(bytes, operations) the paged decode needs on this data: each
    distinct page that holds a valid slot read once (k and v; a row with
    no valid slot needs the V of every page it names, for its uniform
    mean), q read and the output written once; 4*H*D operations per valid
    slot. Also the bytes with pages counted once per row that reads them,
    and the number of distinct pages."""
    nb = bt.shape[1]
    idx = torch.arange(nb * ps)
    valid = torch.repeat_interleave(bt >= 0, ps, dim=1) & \
        (idx[None] <= position[:, None])
    page_valid = valid.reshape(-1, nb, ps).any(-1)            # [B, nb]
    needed = bt[page_valid]
    idle = bt[~page_valid.any(1)].clamp(min=0)
    page_kv = 2 * ps * K * D * itemsize
    io = 2 * len(position) * H * D * itemsize + 4 * (bt.numel() +
                                                     position.numel())
    unique = needed.unique().numel()
    n_bytes = unique * page_kv + idle.unique().numel() * page_kv // 2 + io
    row_bytes = needed.numel() * page_kv + idle.numel() * page_kv // 2 + io
    return n_bytes, 4 * H * D * int(valid.sum()), row_bytes, unique


# B4's three tables at the main shape, the yardstick of its redesign
PAGED_TABLES = ("forked", "distinct", "same")


def main_tables(kind):
    """Block tables of the paged GRPO rollout's last decode step (64 rows of
    36 pages at position 566) and the pool's page count: ``forked`` is the
    rollout's own (8 groups of 8 rows sharing a prompt's first 31 pages),
    ``distinct`` puts every row on 36 pages of its own, ``same`` all rows
    on one row's 36 pages. Each pool has one more page, the rollout's drop
    page."""
    if kind == "forked":
        bt, P = forked_tables(GROUPS, GPROMPT, GSIZE, GEN, PAGE)
        return bt, P + 1
    B, nb = GROUPS * GSIZE, -(-(GPROMPT + GEN) // PAGE)
    if kind == "distinct":
        return torch.arange(B * nb, dtype=torch.int32).reshape(B, nb), \
            B * nb + 1
    return torch.arange(nb, dtype=torch.int32).repeat(B, 1), nb + 1


def check_paged(dev, peaks, g):
    """B4 against its plain version: at the main shape over the forked,
    distinct and same tables (each timed by CUDA-graph replay, warm and
    cold, beside its bound, with its plan and the pages each block copies;
    the forked one also eagerly, with the plain version and the gather +
    SDPA yardstick), with ragged positions and an idle row inside a tile,
    and at edge cases (one forced split, holes, a tail of -1, an idle row,
    head_dim 64, G = 1 and 8, a tile of 5 rows, pages of 32 slots, fp32)."""
    cpu_g = torch.Generator().manual_seed(11)
    cases = [  # (name, B, H, K, D, ps, nb, P, dtype); nb None: main tables
        *[(kind, GROUPS * GSIZE, 24, 8, 128, PAGE, None, None,
           torch.bfloat16) for kind in PAGED_TABLES],
        *[(name, GROUPS * GSIZE, 24, 8, 128, PAGE, None, None,
           torch.bfloat16) for name in ("ragged", "idle_row")],
        # the block normalises its rows itself, with no merge
        ("one_split", 16, 24, 8, 128, 16, 30, 481, torch.bfloat16),
        ("holes", 8, 24, 8, 128, 16, 6, 49, torch.bfloat16),
        ("b13", 13, 24, 8, 128, 16, 9, 118, torch.bfloat16),
        ("ps32", 8, 24, 8, 128, 32, 5, 41, torch.bfloat16),
        ("d64", 6, 8, 2, 64, 16, 5, 31, torch.bfloat16),
        ("k_eq_h", 4, 8, 8, 128, 8, 7, 29, torch.bfloat16),
        ("k1_fp32", 5, 8, 1, 128, 4, 9, 46, torch.float32),
        ("fp32_d64", 4, 6, 2, 64, 16, 6, 25, torch.float32),
        # a tensor-parallel rank's llama3_2_3b heads at ntp 2 (12 query, 4
        # KV): phase 16's paged batcher step, 4 slots over 640 tokens
        ("tp_llama", 4, 12, 4, 128, 16, 40, 161, torch.bfloat16),
        # the paged GRPO step's forked tables at the three families' head
        # layouts (granite's is phase 17's paged rollout)
        *[(fam, GROUPS * GSIZE, H, K, D, PAGE, None, None, torch.bfloat16)
          for fam, (H, K, D) in FAMILY_HEADS.items()],
        # and at phase 19's: qwen1_5_110b (G 8) and command_r_plus_104b
        # (G 12: the 16-head instance, two bf16 n-fragments); G 12 and 16
        # on holey tables in both dtypes and head dims, one forced split
        *[(m, GROUPS * GSIZE, H, K, D, PAGE, None, None, torch.bfloat16)
          for m, (H, K, D) in BIG_HEADS.items()],
        ("g12_holes", 10, 24, 2, 128, 16, 7, 71, torch.bfloat16),
        ("g12_d64", 10, 24, 2, 64, 16, 7, 71, torch.bfloat16),
        ("g12_fp32", 10, 24, 2, 128, 16, 7, 71, torch.float32),
        ("g12_fp32_d64", 9, 12, 1, 64, 8, 12, 109, torch.float32),
        ("g16_one_split", 16, 32, 2, 128, 16, 30, 481, torch.bfloat16),
    ]
    out = []
    for name, B, H, K, D, ps, nb, P, dt in cases:
        if nb is None:
            bt, P = main_tables(name if name in PAGED_TABLES else "forked")
            position = torch.full((B,), GPROMPT + GEN - 2, dtype=torch.int32)
            if name == "ragged":                  # one row per decode step
                position = GPROMPT + torch.arange(B, dtype=torch.int32) % (
                    GEN - 1)
            if name == "idle_row":                # walks all 36 pages alone
                position[13] = -1
        else:
            bt, position = holey_tables(B, nb, ps, P, cpu_g)
        q = torch.randn(B, H, D, generator=g, device=dev).to(dt)
        kp = torch.randn(P, ps, K, D, generator=g, device=dev).to(dt)
        vp = torch.randn(P, ps, K, D, generator=g, device=dev).to(dt)
        bt, position = bt.to(dev), position.to(dev)
        got = pa.paged_decode_attention(
            q, kp, vp, bt, position,
            splits=1 if name.endswith("one_split") else None)
        want = ref.paged_attention_ref(q, kp, vp, bt, position)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rec = {"case": name, "shape": [B, H, K, D, P, ps, bt.shape[1]],
               "dtype": str(dt), "max_err": err,
               "tol": (TOL_GROUP if H // K > 8 else TOL)[dt]}
        if name in PAGED_TABLES or name in FAMILY_HEADS or name in BIG_HEADS:
            n_bytes, n_ops, row_bytes, n_pages = paged_work(
                bt.cpu(), position.cpu(), ps, K, D, H, q.element_size())
            rec["bound_ms"], rec["bound_by"] = bound(peaks, n_bytes, n_ops,
                                                     dt)
            rec.update(unique_pages=n_pages, unique_mib=n_bytes / 2**20,
                       per_row_mib=row_bytes / 2**20)
            pl = pa.plan(B, K, bt.shape[1])
            loads = pa.block_loads(bt, position, ps, pl)
            rec.update(plan=pl._asdict(), page_loads=int(loads.sum()),
                       block_loads_max=int(loads.max()),
                       block_loads_mean=loads.float().mean().item())

            def make_set():
                return tuple(torch.randn(*t.shape, device=dev).to(dt)
                             for t in (q, kp, vp))
            rec["device_ms"], rec["cold_ms"] = time_graph_warm_cold(
                lambda q_, k_, v_: pa.paged_decode_attention(
                    q_, k_, v_, bt, position), make_set)
        if name == "forked":
            rec["ms"] = time_ms(lambda: pa.paged_decode_attention(
                q, kp, vp, bt, position), iters=50)
            rec["plain_ms"] = time_ms(lambda: ref.paged_attention_ref(
                q, kp, vp, bt, position))
            # no one PyTorch call computes this function; gather + SDPA is
            # a two-call yardstick, not the library column
            idx = torch.arange(bt.shape[1] * ps, device=dev)
            valid = torch.repeat_interleave(bt >= 0, ps, dim=1) & \
                (idx[None] <= position[:, None])
            mask = valid[:, None, None, :]

            def yardstick():
                k, v = gather_kv({"k": kp, "v": vp}, bt)
                return _gqa_sdpa(q[:, None], k, v, attn_mask=mask)

            rec["yardstick_ms"] = time_ms(yardstick)
            rec["library_ms"] = None
        out.append(rec)
    return out


# ---------------------------------------------------------------- phase 4
def check_result(res, rows, prompt, vocab):
    if res.tokens.shape != (rows, prompt + GEN):
        raise SystemExit(f"bad result shape {tuple(res.tokens.shape)}")
    gen = res.tokens[:, prompt:]
    lp = res.logp[:, prompt:]
    if not (int(gen.min()) >= 0 and int(gen.max()) < vocab):
        raise SystemExit("generated token out of the vocabulary")
    if not (torch.isfinite(lp).all() and (lp <= 1e-6).all()):
        raise SystemExit("bad logp")
    if float(res.mask[:, prompt:].min()) != 1.0:
        raise SystemExit("bad mask")


def check_outputs(results, vocab):
    for r in results:
        check_result(r["result"], BATCH, PROMPT, vocab)


# ---------------------------------------------------------------- phase 5
def _alloc(dev) -> int:
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def _req(fn, dev=None):
    """Run one generate call (or step) on ``dev``, the card by default;
    (result, seconds, peak bytes allocated above what was live before it:
    0 on the CPU)."""
    dev = dev or torch.device("cuda")
    _sync(dev)
    base = _alloc(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = fn()
    _sync(dev)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base \
        if dev.type == "cuda" else 0
    return res, secs, peak


def paged_grpo(cfg, dev, log, profile=False):
    """Phase 5: the paged GRPO rollout at full width and depth, checked
    launch for launch, against one dense request of the repeated prompts.
    Returns the report and the launch counts of the paged requests; with
    ``profile``, also a profile of one more paged request."""
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    weights = torch.cuda.memory_allocated()
    data = PromptDataset(synthetic_instruction_prompts(
        GROUPS * GREQUESTS, seed=0), GPROMPT).batches(GROUPS, seed=0)
    prompts = [torch.from_numpy(next(data) % cfg.vocab_size).long().to(dev)
               for _ in range(GREQUESTS)]
    gen_kw = dict(temperature=0.8, top_k=serve.TOP_K)
    paged = Rollout(model, cfg, capacity=GPROMPT + GEN, backend="paged",
                    page_size=PAGE, **gen_kw)
    L = cfg.num_layers
    # rmsnorm: + 1 for the group's replicated unembedding after the prefill
    per_request = {"rmsnorm": (2 * L + 1) * GEN + 1, "flash_attention": L,
                   "decode_attention": 0,
                   "paged_decode_attention": L * (GEN - 1), "ssd_scan": 0,
                   "flash_attention_bwd": 0, "rmsnorm_bwd": 0}
    rows = GROUPS * GSIZE
    reqs = []
    torch.cuda.synchronize()
    ops.reset_launches()
    for r, ids in enumerate(prompts):
        before = dict(ops.launches)
        res, secs, peak = _req(lambda: paged.generate(
            params, {"tokens": ids}, GEN,
            torch.Generator(device=dev).manual_seed(r + 1),
            group_size=GSIZE))
        made = {k: ops.launches[k] - before[k] for k in ops.KERNELS}
        if made != per_request:
            raise SystemExit(f"paged request {r}: launches {made} != "
                             f"{per_request}")
        st = paged.page_manager.stats
        if st.n_forks != GROUPS * (GSIZE - 1) or st.pages_in_use != 0:
            raise SystemExit(f"paged request {r}: page stats {st}")
        check_result(res, rows, GPROMPT, cfg.vocab_size)
        page_peak = st.peak_pages_in_use * paged.page_manager.page_bytes
        reqs.append({"seconds": secs, "tokens_per_s": rows * GEN / secs,
                     "peak_above_weights": peak, "page_peak_bytes": page_peak,
                     "num_pages": st.num_pages, "cow_copies": st.n_cow_copies,
                     "forks": st.n_forks, "result": res})
        log(f"[smoke] paged request {r}: {secs * 1e3:.1f} ms "
            f"({rows * GEN / secs:.1f} tok/s), peak {peak / 2**20:.1f} MiB "
            f"above the weights, page peak {st.peak_pages_in_use} pages = "
            f"{page_peak / 2**20:.1f} MiB, {st.n_cow_copies} CoW copies")
    torch.cuda.synchronize()
    launches = dict(ops.launches)

    # the same prompts through the dense backend, repeated to 64 rows
    dense = Rollout(model, cfg, capacity=GPROMPT + GEN, **gen_kw)
    res_d, secs_d, peak_d = _req(lambda: dense.generate(
        params, {"tokens": prompts[0]}, GEN,
        torch.Generator(device=dev).manual_seed(1), group_size=GSIZE))
    check_result(res_d, rows, GPROMPT, cfg.vocab_size)
    log(f"[smoke] dense repeat: {secs_d * 1e3:.1f} ms "
        f"({rows * GEN / secs_d:.1f} tok/s), peak {peak_d / 2**20:.1f} MiB "
        f"above the weights")
    if not reqs[0]["peak_above_weights"] < peak_d:
        raise SystemExit(f"paged fork peak {reqs[0]['peak_above_weights']} "
                         f"not below the dense repeat's {peak_d}")

    # the first sampled step, read from the two timed results: the same
    # generator seed and, to bf16 rounding, the same logits (cuBLAS may pick
    # other kernels for the 8 x 504 and 64 x 504 prefills) give the same
    # first tokens and log-probs
    res_f = reqs[0]["result"]
    same_first = torch.equal(res_f.tokens[:, GPROMPT],
                             res_d.tokens[:, GPROMPT])
    lp_f, lp_d = res_f.logp[:, GPROMPT].float(), res_d.logp[:, GPROMPT].float()
    err = (lp_f - lp_d).abs().max().item()
    scale = lp_d.abs().max().item()
    same_all = (res_f.tokens[:, GPROMPT:] == res_d.tokens[:, GPROMPT:]
                ).float().mean().item()
    log(f"[smoke] fork vs repeat, first step: tokens identical {same_first}, "
        f"logp max_err {err:.3e} (max |logp| {scale:.3f}); {same_all:.3f} of "
        f"all {GEN} steps' tokens identical")
    if not same_first:
        raise SystemExit("fork vs repeat: first sampled tokens differ")
    if not err <= TOL[torch.bfloat16] * max(1.0, scale):
        raise SystemExit(f"fork vs repeat first-step logp differ by {err}")
    for r in reqs:
        del r["result"]
    out = {}
    if profile:
        out["profile"], out["profile_table"] = profile_call(
            lambda: paged.generate(params, {"tokens": prompts[0]}, GEN,
                                   torch.Generator(device=dev).manual_seed(1),
                                   group_size=GSIZE))
    return {**out, "requests": reqs, "weights_bytes": weights,
            "dense": {"seconds": secs_d, "tokens_per_s": rows * GEN / secs_d,
                      "peak_above_weights": peak_d},
            "first_step_logp_max_err": err, "max_abs_logp": scale,
            "same_first_tokens": same_first, "same_tokens": same_all,
            "launches": launches}


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return [_to(v, device) for v in tree]


def check_small_model_against_cpu(dev, cfg=None, prompt=40, seed=3):
    """A small model (default: a GQA smoke model, G = 2, head_dim 64, f32)
    on the card through the kernels vs the same weights on the CPU through
    the plain versions: prefill logits within 1e-4 and 16 greedy tokens
    identical."""
    if cfg is None:
        cfg = dataclasses.replace(get_config("llama3_2_3b").smoke(),
                                  num_kv_heads=2)
    cpu_model = Model(cfg, device="cpu")
    params = cpu_model.init(torch.Generator().manual_seed(seed))
    gpu_model = Model(cfg, device=dev)
    gparams = _to(params, dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, prompt),
                           generator=torch.Generator().manual_seed(seed + 1))
    # prefix or frame embeddings, where the config takes them
    extra = {} if cfg.input_mode == "tokens" else emb_inputs(
        cfg, 2, torch.Generator().manual_seed(seed + 2), "cpu")
    cap = TS._prefix_len(cfg) + prompt + 24
    results = []
    for model, p, device in ((cpu_model, params, "cpu"),
                             (gpu_model, gparams, dev)):
        ro = Rollout(model, cfg, capacity=cap, temperature=0.0)
        batch = {k: v.to(device) for k, v in
                 dict(extra, tokens=tokens).items()}
        logits, _ = model.prefill(p, batch, cap)
        res = ro.generate(p, batch, 16, torch.Generator(device=device))
        results.append((logits.cpu(), res.tokens.cpu()))
    err = (results[0][0] - results[1][0]).abs().max().item()
    assert err <= 1e-4, f"small model prefill logits differ by {err}"
    assert torch.equal(results[0][1], results[1][1]), "greedy tokens differ"
    return err


def time_split(model, params, batch, prompt):
    """Unprofiled prefill time and mean decode-step time (host clock,
    synchronised; greedy) of one request, after a warm-up request."""
    dev = model.device
    ro = Rollout(model, model.cfg, capacity=prompt + GEN, temperature=0.8,
                 top_k=serve.TOP_K)
    toks = torch.randint(0, 256, (batch, prompt), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    ro.generate(params, {"tokens": toks}, GEN, g)      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, {"tokens": toks}, prompt + GEN)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tok = torch.argmax(logits, -1)
    for t in range(GEN - 1):
        pos = torch.full((batch,), prompt + t, dtype=torch.int32, device=dev)
        logits, caches = model.decode_step(params, caches, tok, pos)
        tok = torch.argmax(logits, -1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del caches
    return ro, toks, g, {"prefill_ms": (t1 - t0) * 1e3,
                         "decode_step_ms": (t2 - t1) * 1e3 / (GEN - 1)}


def profile_request(cfg, dev):
    """Where one request's time goes: prefill and per-decode-step wall
    time (host clock, synchronised), then kernel time by name over one
    whole request (torch.profiler; kernel events only, so the device's
    busy time is the sum of its kernels)."""
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    ro, toks, g, split = time_split(model, params, BATCH, PROMPT)
    prof, table = profile_call(lambda: ro.generate(params, {"tokens": toks},
                                                   GEN, g))
    prof.update(split)
    return prof, table


def mamba_serving(dev, log, profile=False):
    """Phase 6: mamba2_370m at full width and depth through serve.run, 3
    requests of 8 x (2048 + 64); launch counts asserted (B5 once per
    layer in each prefill, B1 at norm1 and the gated norm of each layer
    and the final norm, every step), outputs checked; then the prefill
    and decode step timed apart on a model of its own (with ``profile``,
    also one profiled request) and a small Mamba model on the card
    against the CPU."""
    cfg = get_config("mamba2_370m")
    torch.cuda.synchronize()
    ops.reset_launches()
    results = serve.run(cfg, batch=MBATCH, prompt_len=MPROMPT, gen=GEN,
                        requests=MREQUESTS, temperature=0.8, seed=0,
                        device=dev, log=log)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    L = cfg.num_layers
    want = {"flash_attention": 0, "decode_attention": 0,
            "paged_decode_attention": 0, "ssd_scan": L * MREQUESTS,
            "rmsnorm": (2 * L + 1) * GEN * MREQUESTS,
            "flash_attention_bwd": 0, "rmsnorm_bwd": 0}
    log(f"[smoke] mamba launches {launches} (want {want})")
    if launches != want:
        raise SystemExit(f"mamba launch counts {launches} != {want}")
    reqs = []
    for r in results:
        check_result(r["result"], MBATCH, MPROMPT, cfg.vocab_size)
        # live after the request is the weights (the states were dropped)
        above = r["peak_bytes"] - r["live_bytes"]
        reqs.append({"seconds": r["seconds"],
                     "tokens_per_s": r["tokens_per_s"],
                     "live_bytes": r["live_bytes"],
                     "peak_bytes": r["peak_bytes"],
                     "peak_above_weights": above})
        log(f"[smoke] mamba request: {r['seconds'] * 1e3:.1f} ms "
            f"({r['tokens_per_s']:.1f} tok/s), peak {above / 2**20:.1f} MiB "
            f"above the weights ({r['live_bytes'] / 2**20:.1f} MiB live)")
    del results
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    ro, toks, g, split = time_split(model, params, MBATCH, MPROMPT)
    log(f"[smoke] mamba unprofiled: prefill {split['prefill_ms']:.1f} ms, "
        f"decode {split['decode_step_ms']:.2f} ms/step (greedy)")
    out = {"requests": reqs, "launches": launches, **split}
    if profile:
        out["profile"], out["profile_table"] = profile_call(
            lambda: ro.generate(params, {"tokens": toks}, GEN, g))
    del model, params, ro
    small = get_config("mamba2_370m").smoke()
    out["small_model_max_err"] = check_small_model_against_cpu(
        dev, small, prompt=64, seed=5)
    log(f"[smoke] small Mamba model card vs CPU: logits max_err "
        f"{out['small_model_max_err']:.3e}, 16 greedy tokens identical")
    return out


# ---------------------------------------------------------------- phase 7
def _layer_norms(cfg, kind, moe) -> int:
    """B1 calls of one layer: norm1, a Mamba layer's gated norm, an MLA
    layer's q_norm and kv_norm, and norm2 where the layer has an FFN
    (dense where ``d_ff``, MoE where ``moe``)."""
    return 1 + (kind == "mamba") + 2 * (kind == "mla") + \
        bool(cfg.d_ff or (moe and cfg.moe is not None))


def step_norms(cfg) -> int:
    """B1 calls of one pass over ``cfg``'s layers and the final norm
    (:func:`_layer_norms` a layer): 2L + 1 for attention layers with FFNs,
    MoE or dense; 4L + 1 for MLA layers."""
    return 1 + sum(_layer_norms(cfg, kind, moe) for kind, moe in
                   zip(cfg.layer_kinds(), cfg.layer_is_moe()))


def attention_layers(cfg) -> int:
    """Layers whose prefill and training attention is B2 (and B2-bwd):
    attention and MLA layers."""
    return sum(k in ("attn", "mla") for k in cfg.layer_kinds())


def mtp_norms(cfg) -> int:
    """B1 calls of one MTP module: norm_h, norm_e, its layer's norms (the
    reference's last segment's first slot: MoE unless the model is cut to
    its dense leading layers) and the final norm: 5 on an attention
    model, 7 on an MLA one."""
    moe = cfg.num_layers > cfg.first_k_dense and cfg.moe_period[0]
    return 3 + _layer_norms(cfg, cfg.period[0], moe)


def ppo_launches(cfg, rl, model_reward: bool, critic_cfg=None,
                 spec_steps: int = 0) -> dict:
    """Kernel launches of one PPO iteration, reckoned from the shapes
    (ppo_epochs updates of each role). ``cfg`` is the actor's; on the
    separate engine the reward model, the values and the critic's step
    run ``critic_cfg``'s depth (the hydra engine's roles all run the one
    trunk).
    Counts are per attention layer (B2, B3, B2-bwd) and per Mamba layer
    (B5, which has no backward kernel; a hybrid's), and B1's per pass
    come from :func:`step_norms` (2L + 1 below, for attention layers with
    FFNs; a layer with an MoE FFN has its norm2 as a dense one does).
    - rollout: B2 once a layer (prefill), B3 once a layer at each of the
      gen - 1 decode steps, B1 at norm1, norm2 and the final norm of the
      prefill and each step: (2L + 1) gen; with ``rl.spec_decode``, the
      speculative rollout of ``spec_steps`` verify steps instead
      (:func:`spec_launches`: no B3);
    - each scoring forward (reward if a model scores, ref, values, old
      logp): B2 L, B1 2L + 1;
    - each training step (actor, critic): the forward (B2 L, B1 2L + 1);
      with remat other than "none" ("full", "dots", "offload") each
      layer's forward again inside the backward (B2 L, B1 2L; the final
      norm is outside the checkpoints); the
      backward: B2-bwd L and B1-bwd at every norm whose input or scale
      trains: 2L + 1 on the separate engine, where every leaf trains, 2L
      on the hydra engine (the final norm, every norm2 and the norm1 of
      layers 1 .. L-1: layer 0's norm1 reads the frozen embedding with a
      frozen scale, so no gradient reaches it);
    - with ``cfg.mtp_depth`` D, each actor step also runs the MTP chain
      (never checkpointed): B2 D, B1 5D (norm_h, norm_e, the module
      layer's two norms, the final norm; :func:`mtp_norms`), B2-bwd D and
      B1-bwd 5D on the separate engine, 4D on the hydra engine (norm_e
      reads the frozen embedding with a frozen scale).
    An MLA layer counts as an attention layer, with two norms more."""
    separate = rl.engine == "separate"

    def role(c):     # (attention layers, Mamba layers, B1 a pass, remat)
        attn = attention_layers(c)
        return (attn, sum(k == "mamba" for k in c.layer_kinds()),
                step_norms(c), c.remat != "none")

    actor = role(cfg)
    critic = role(critic_cfg if separate and critic_cfg is not None
                  else cfg)
    scored = [actor, actor, critic] + ([critic] if model_reward else [])
    trained = [actor, critic] * rl.ppo_epochs
    (La, Ma, _, _), gen = actor, rl.gen_len
    want = {k: 0 for k in ops.KERNELS}
    if rl.spec_decode:
        want.update(spec_launches(cfg, spec_steps, rl.spec_k))
    else:
        want["flash_attention"] = La
        want["decode_attention"] = La * (gen - 1)
        want["ssd_scan"] = Ma
        want["rmsnorm"] = step_norms(cfg) * gen
    for key, i in (("flash_attention", 0), ("ssd_scan", 1)):
        want[key] += sum(r[i] for r in scored) + \
            sum(r[i] * (1 + r[3]) for r in trained)
    want["rmsnorm"] += sum(n for _, _, n, _ in scored) + \
        sum(n + remat * (n - 1) for _, _, n, remat in trained)
    want["flash_attention_bwd"] = sum(L for L, _, _, _ in trained)
    want["rmsnorm_bwd"] = sum(n - 1 + separate for _, _, n, _ in trained)
    D, n = cfg.mtp_depth * rl.ppo_epochs, mtp_norms(cfg)
    want["flash_attention"] += D
    want["rmsnorm"] += n * D
    want["flash_attention_bwd"] += D
    want["rmsnorm_bwd"] += (n if separate else n - 1) * D
    return want


def train_launches(cfg, microbatches: int) -> dict:
    """Kernel launches of one full-parameter ``make_train_step`` step of
    kind "lm" at ``microbatches``: per microbatch the forward (B2 a B2
    layer, B1 :func:`step_norms`), with remat each layer's forward again
    inside the backward (B2 and B1 but the final norm), the backward
    (B2-bwd a B2 layer, B1-bwd at every norm: every leaf trains), and with
    MTP heads the chain (B2, B1 and their backward once a depth, the
    module's norms each)."""
    L, n = attention_layers(cfg), step_norms(cfg)
    remat = cfg.remat != "none"
    D, m = cfg.mtp_depth, mtp_norms(cfg) if cfg.mtp_depth else 0
    want = {k: 0 for k in ops.KERNELS}
    want.update(flash_attention=L * (1 + remat) + D,
                rmsnorm=n + remat * (n - 1) + m * D,
                flash_attention_bwd=L + D, rmsnorm_bwd=n + m * D)
    return {k: v * microbatches for k, v in want.items()}


def spec_launches(cfg, steps: int, spec_k: int) -> dict:
    """Kernel launches of one speculative rollout call of ``steps``
    verify steps: the prefill (B2 L, B1 2L + 1), then each step's spec_k
    MTP drafts (each one layer at one position: B2 1, B1 5) and its
    verify forward (B1 2L + 1; its attention is the plain masked softmax,
    so neither B3 nor B4)."""
    L = cfg.num_layers
    want = {k: 0 for k in ops.KERNELS}
    want["flash_attention"] = L + spec_k * steps
    want["rmsnorm"] = (2 * L + 1) * (1 + steps) + 5 * spec_k * steps
    return want


def forced_drafts(model, continuation: torch.Tensor, spec_k: int):
    """Stand-in for ``model.mtp_draft`` that proposes a known greedy
    continuation (``continuation`` [B, N], the generated tokens of a
    greedy run: vanilla's, or the spec run's own): a counter on the
    tensors' device follows the rows through the calls, k+1 tokens a
    call, as full acceptance advances them (so no host read, and a CUDA
    graph captures it). A row that rejects has left the continuation (a
    near-tie flipped) and drafts wrong from then on, so the call takes
    more steps; the index stops at a zero column past the end, and
    verification keeps the output exact. Each call still runs the heads'
    own ``mtp_draft`` (the k MTP layers and their unembeds) and drops its
    drafts, so a step costs what it would with heads that drafted right.
    Set it as ``model.mtp_draft`` on an instance; never in the package."""
    heads = model.mtp_draft
    B, N = continuation.shape
    dev = continuation.device
    pad = torch.cat([continuation, torch.zeros(
        (B, 1), dtype=continuation.dtype, device=dev)], dim=1)
    cursor = torch.zeros((), dtype=torch.long, device=dev)
    ks = torch.arange(1, spec_k + 1, device=dev)

    def draft(params, h_last, first_tok, k):
        heads(params, h_last, first_tok, k)
        idx = torch.clamp(cursor + ks, max=N)[None].expand(B, k)
        out = torch.gather(pad, 1, idx)
        cursor.add_(k + 1)
        return out

    return draft


PPO_KW = dict(engine="hydra", lora_rank=128, prompt_len=PPROMPT,
              gen_len=GEN, kl_coef=0.1, temperature=1.0, top_k=50,
              ppo_epochs=1)


def _phase_rows(records, weights):
    """Per-phase ms and live/reserved/peak MiB above the weights."""
    return [{"phase": r["phase"], "kind": r["kind"],
             "ms": r["seconds"] * 1e3,
             "hygiene_ms": r.get("hygiene_seconds", 0.0) * 1e3,
             "live_mib": (r["live_bytes"] - weights) / 2**20,
             "reserved_mib": (r["reserved_bytes"] - weights) / 2**20,
             "peak_mib": (r["peak_bytes"] - weights) / 2**20}
            for r in records]


def _print_phases(label, rows, log):
    log(f"[smoke] {label}: phase ms (of which boundary gc + empty_cache) "
        f"/ MiB above the weights (live, reserved, peak)")
    for r in rows:
        log(f"  {r['phase']:16s} {r['ms']:9.1f} ms ({r['hygiene_ms']:7.1f}) "
            f"{r['live_mib']:9.1f} {r['reserved_mib']:9.1f} "
            f"{r['peak_mib']:9.1f}")


def _requested() -> int:
    """Bytes the caching allocator was asked for and holds, unrounded."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def _fresh(make):
    """(what ``make()`` builds, the bytes it leaves allocated, the bytes
    it asked the allocator for)."""
    gc.collect()
    torch.cuda.synchronize()
    before, asked = torch.cuda.memory_allocated(), _requested()
    obj = make()
    torch.cuda.synchronize()
    return (obj, torch.cuda.memory_allocated() - before,
            _requested() - asked)


def _run_ppo(tr, prompts, g, want, label, n_records):
    """One asserted PPO iteration: launches as reckoned, finite metrics;
    -> (seconds, metrics, launches, its ``n_records`` phase records)."""
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    m = tr.train_step(prompts, g)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    made = dict(ops.launches)
    if made != want:
        raise SystemExit(f"{label}: launches {made} != {want}")
    if not all(math.isfinite(v) for v in m.values()):
        raise SystemExit(f"{label}: metrics {m}")
    return secs, m, made, tr.memory.records[-n_records:]


def _trainer(cfg, dev, policy, seed=0):
    """A fresh trainer and the bytes its persistent state holds (trunk,
    adapters, AdamW moments): what the records are read above."""
    return _fresh(lambda: RLHFTrainer(
        cfg, cfg, RLHFConfig(memory_policy=policy, **PPO_KW),
        torch.Generator(device=dev).manual_seed(seed)))[:2]


def ppo_iterations(dev, log, profile=False):
    """Phase 7: PITERS hydra PPO iterations of full llama3_2_3b (28
    layers, rank-128 adapters on all seven projections, 8 x (512 + 64)),
    the reward adapter scoring, remat="full": every phase runs the model.
    Asserts the launches of all seven counters per iteration, finite
    losses, a trunk unchanged bit for bit and moved adapters; prints each
    phase's ms and memory; then one iteration of a fresh trainer under
    memory_policy="none"; then a small model's 2 greedy fp32 PPO steps
    on the card against the CPU."""
    cfg = get_config("llama3_2_3b")
    tr, weights = _trainer(cfg, dev, "after_inference")
    want = ppo_launches(cfg, tr.rl, model_reward=True)
    log(f"[smoke] ppo: trunk {tr.engine.base_param_count() / 1e6:.1f}M "
        f"params, adapter {tr.engine.adapter_param_count('actor') / 1e6:.1f}M"
        f" (actor), persistent {weights / 2**30:.2f} GiB")
    trunk = [t.cpu() for t in leaves(tr.base_params)]
    adapters = {role: [t.detach().cpu() for t in
                       leaves(tr.engine.adapters[role])]
                for role in ("actor", "critic")}
    data = PromptDataset(synthetic_instruction_prompts(
        PBATCH * PITERS, seed=1), PPROMPT).batches(PBATCH, seed=1)
    g = torch.Generator(device=dev).manual_seed(7)
    iters = []
    launches = None
    for it in range(PITERS):
        prompts = torch.from_numpy(next(data) % cfg.vocab_size).long().to(dev)
        secs, m, launches, recs = _run_ppo(tr, prompts, g, want,
                                           f"ppo iteration {it}", 8)
        rows = _phase_rows(recs, weights)
        _print_phases(f"ppo iteration {it} ({secs * 1e3:.1f} ms)", rows, log)
        log(f"[smoke] ppo iteration {it}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in sorted(m.items())))
        iters.append({"seconds": secs, "metrics": m, "phases": rows})
        if it == ZERO_NCCL_ITERS - 1:     # phase 15 holds ZeRO's to it
            trained = _trained_fingerprint(tr)
    for a, b in zip(trunk, leaves(tr.base_params)):
        if not torch.equal(a, b.cpu()):
            raise SystemExit("ppo: the frozen trunk moved")
    for role, before in adapters.items():
        if all(torch.equal(a, b.detach().cpu()) for a, b in
               zip(before, leaves(tr.engine.adapters[role]))):
            raise SystemExit(f"ppo: the {role} adapter did not move")
    log(f"[smoke] ppo launches per iteration {launches} (want {want}); "
        f"trunk unchanged, actor and critic adapters moved")
    out = {"iterations": iters, "launches": launches,
           "weights_bytes": weights, "trained": trained}
    if profile:
        prompts = torch.from_numpy(next(PromptDataset(
            synthetic_instruction_prompts(PBATCH, seed=2), PPROMPT).batches(
                PBATCH, seed=2)) % cfg.vocab_size).long().to(dev)
        out["profile"], out["profile_table"] = profile_call(
            lambda: tr.train_step(prompts, g))
    del tr, trunk, adapters
    gc.collect()
    torch.cuda.empty_cache()

    # the paper's boundary empty_cache, on the real allocator: the same
    # iteration with no hygiene at the boundaries
    tr, weights = _trainer(cfg, dev, "none")
    prompts = torch.from_numpy(next(PromptDataset(
        synthetic_instruction_prompts(PBATCH, seed=1), PPROMPT).batches(
            PBATCH, seed=1)) % cfg.vocab_size).long().to(dev)
    tr.train_step(prompts, g)
    rows = _phase_rows(tr.memory.records[-8:], weights)
    _print_phases("ppo iteration, memory_policy=none", rows, log)
    out["policy_none"] = rows
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    out["small_model"] = check_small_ppo_against_cpu(dev)
    log(f"[smoke] small model PPO card vs CPU: greedy tokens identical, "
        f"metrics max_err {out['small_model']['max_err']:.3e}")
    return out


def check_small_ppo_against_cpu(dev, steps=2, tol=1e-4, engine="hydra",
                                spec=False):
    """2 greedy fp32 PPO steps of a small model on the card and on the CPU
    from the same weights: the same greedy tokens, and the metrics within
    ``tol`` (fp32 sums in another order). ``spec``: the actor has 2 MTP
    heads and the rollout is speculative (``spec_decode``, k 2). Hydra: the reference tests'
    small config, remat="full" and the reward adapter, so every kernel and
    its backward runs. Separate: the paper pair's shape (MHA, qkv biases,
    a GELU MLP, tied embeddings), an actor of d_model 128 (remat="none")
    and a critic of 64 (remat="full"), heads of 64, every leaf trained,
    the reward model scoring."""
    small = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=64,
                 num_heads=4, head_dim=64, remat="full")
    kw = dict(prompt_len=8, gen_len=8, temperature=0.0, top_k=0,
              spec_decode=spec)
    mtp = dict(mtp_depth=2 if spec else 0)
    if engine == "hydra":
        cfg = dataclasses.replace(get_config("llama3_2_3b").smoke(),
                                  num_kv_heads=2, **small, **mtp)
        rl = RLHFConfig(engine="hydra", lora_rank=4, lr=3e-3,
                        critic_lr=3e-3, **kw)
        cpu = RLHFTrainer(cfg, cfg, rl, torch.Generator().manual_seed(0))
        eng = cpu.engine
        card = RLHFTrainer(cfg, cfg, rl, engine=ModelEngine(
            cfg, None, rank=rl.lora_rank,
            base_params=_to(eng.base_params, dev),
            adapters={r: _to(a, dev) for r, a in eng.adapters.items()}))
    else:
        cfg = dataclasses.replace(get_config(SEP_CRITIC).smoke(),
                                  num_kv_heads=4, **small)
        actor = dataclasses.replace(get_config(SEP_ACTOR).smoke(),
                                    **{**small, "num_kv_heads": 4,
                                       "d_model": 128, "d_ff": 256,
                                       "remat": "none"}, **mtp)
        rl = RLHFConfig(engine="separate", lr=1e-3, critic_lr=1e-3, **kw)
        cpu = RLHFTrainer(actor, cfg, rl, torch.Generator().manual_seed(0))
        card = RLHFTrainer(actor, cfg, rl, params={
            "actor": _to(cpu.actor_state["params"], dev),
            "critic": _to(cpu.critic_state["params"], dev)})
    prompts = torch.randint(0, cfg.vocab_size, (4, rl.prompt_len),
                            generator=torch.Generator().manual_seed(1))
    got = {}
    for name, tr in (("cpu", cpu), ("card", card)):
        toks, gen = [], tr._gen

        def spy(p, gg, gen=gen, toks=toks):
            ro = gen(p, gg)
            toks.append(ro.tokens.cpu())
            return ro
        tr._gen = spy
        ms = [tr.train_step(prompts.to(tr.device),
                            torch.Generator(device=tr.device))
              for _ in range(steps)]
        got[name] = (toks, ms)
    if not all(torch.equal(a, b) for a, b in zip(got["cpu"][0],
                                                  got["card"][0])):
        raise SystemExit(f"small {engine} PPO: greedy tokens differ card vs "
                         "CPU")
    if spec and not all("mtp_loss" in m for m in got["card"][1]):
        raise SystemExit(f"small spec {engine} PPO: no mtp_loss")
    err = max(abs(a[k] - b[k]) for a, b in zip(got["cpu"][1], got["card"][1])
              for k in a)
    if not err <= tol:
        raise SystemExit(f"small {engine} PPO: metrics differ by {err}: "
                         f"{got}")
    return {"max_err": err, "tol": tol, "metrics": got["card"][1]}


# ---------------------------------------------------------------- phase 8
SEP_KW = dict(prompt_len=SPROMPT, gen_len=SGEN, kl_coef=0.1,
              temperature=1.0, top_k=50, ppo_epochs=1)


def _study_pair():
    """Phase 8's OPT pair at ``STUDY_LAYERS`` layers (phases 9 and 11)."""
    return tuple(dataclasses.replace(get_config(n), num_layers=STUDY_LAYERS)
                 for n in (SEP_ACTOR, SEP_CRITIC))


def _separate_trainer(dev, policy, seed=0, pair=None):
    actor, critic = pair or (get_config(SEP_ACTOR), get_config(SEP_CRITIC))
    return _fresh(lambda: RLHFTrainer(
        actor, critic, RLHFConfig(engine="separate", memory_policy=policy,
                                  **SEP_KW),
        torch.Generator(device=dev).manual_seed(seed)))


def _sep_prompts(dev, seed, vocab):
    return torch.from_numpy(next(PromptDataset(synthetic_instruction_prompts(
        SBATCH, seed=seed), SPROMPT).batches(SBATCH, seed=seed)) % vocab
    ).long().to(dev)


def _accounting_gb(acc):
    """{layout: {"state": params + opt, "grad": ...}} in GB (1e9 bytes)."""
    return {layout: {"state": sum(r["params"] + r["opt"]
                                  for r in roles.values()) / 1e9,
                     "grad": sum(r["grad"] for r in roles.values()) / 1e9}
            for layout, roles in acc.items()}


def _norm_scales(params):
    """The norm scales of a model's tree: the final norm and every layer's
    norm1 and norm2."""
    return [params["final_norm"]["scale"]] + [
        layer[n]["scale"] for layer in params["layers"]
        for n in ("norm1", "norm2") if n in layer]


def _unmoved(tr, before):
    """{role: the number of norm scales equal to ``before``'s copies};
    raises if a trained leaf's first moment is zero (no gradient reached
    it) or if a leaf other than a norm scale did not move."""
    still = {}
    for role, copies in before.items():
        state = getattr(tr, role + "_state")
        scales = {id(t) for t in _norm_scales(state["params"])}
        for i, (a, b, mu) in enumerate(zip(copies, leaves(state["params"]),
                                           leaves(state["opt"]["mu"]))):
            if not mu.any():
                raise SystemExit(f"separate: {role} leaf {i} "
                                 f"{tuple(a.shape)} got no gradient")
            if torch.equal(a, b.detach().cpu()):
                if id(b) not in scales:
                    raise SystemExit(f"separate: {role} leaf {i} "
                                     f"{tuple(a.shape)} did not move")
                still[role] = still.get(role, 0) + 1
    return still


def separate_ppo(dev, log, profile=False):
    """Phase 8: the paper's four-model PPO (engine="separate") on its own
    pair, full width and depth, bf16: SITERS iterations under
    ``after_inference`` with the launches of all seven counters asserted
    (``ppo_launches`` from each config's depth), finite metrics, the
    reference and reward models unchanged bit for bit, every actor and
    critic leaf given a gradient and moved (a bf16 norm scale of 1.0
    cannot move at lr 1e-5: its step is below half a bf16 ulp), the
    persistent bytes equal to the six trees' ``nbytes``; each phase's ms
    and memory printed; then one iteration of a fresh trainer under
    ``none``; one hydra iteration of the actor's config at the same shape
    (the repo's alleviation beside the paper's layout); the ported
    ``memory_accounting`` of llama3_2_3b (whose separate layout does not
    fit the card); and a small model's 2 greedy fp32 separate iterations
    on the card against the CPU."""
    actor_cfg, critic_cfg = get_config(SEP_ACTOR), get_config(SEP_CRITIC)
    tr, weights, asked = _separate_trainer(dev, "after_inference")
    trees = tr.persistent_trees()
    tree_bytes = tree_nbytes(trees)
    sizes = [t.numel() * t.element_size() for t in leaves(trees)]
    # the caching allocator rounds every block up to 512 bytes, and gives a
    # block above 1 MiB its whole free block when no more than 1 MiB would
    # be left over
    slack = 512 * len(sizes) + 2**20 * sum(n > 2**20 for n in sizes)
    if asked != tree_bytes or not 0 <= weights - tree_bytes <= slack:
        raise SystemExit(f"separate: {asked} bytes asked, {weights} "
                         f"allocated for a state of {tree_bytes} "
                         f"({len(sizes)} tensors)")
    count = lambda t: sum(x.numel() for x in leaves(t))  # noqa: E731
    log(f"[smoke] separate: actor {count(trees['actor_params']) / 1e6:.1f}M "
        f"params, critic {count(trees['critic_params']) / 1e6:.1f}M; "
        f"persistent {asked} bytes asked of the allocator ({weights} "
        f"allocated), six trees {tree_bytes} bytes, "
        f"{tree_bytes / 1e9:.3f} GB (" + ", ".join(
            f"{k} {tree_nbytes(v) / 1e9:.3f}" for k, v in trees.items()) + ")")
    want = ppo_launches(actor_cfg, tr.rl, model_reward=True,
                        critic_cfg=critic_cfg)
    frozen = [t.to("cpu", copy=True)
              for t in leaves([tr.ref_params, tr.reward_params])]
    trained = {role: [t.detach().to("cpu", copy=True) for t in
                      leaves(getattr(tr, role + "_state")["params"])]
               for role in ("actor", "critic")}
    g = torch.Generator(device=dev).manual_seed(7)
    iters, launches = [], None
    for it in range(SITERS):
        secs, m, launches, recs = _run_ppo(
            tr, _sep_prompts(dev, 1 + it, actor_cfg.vocab_size), g, want,
            f"separate iteration {it}", 7)
        rows = _phase_rows(recs, weights)
        _print_phases(f"separate iteration {it} ({secs * 1e3:.1f} ms)", rows,
                      log)
        log(f"[smoke] separate iteration {it}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in sorted(m.items())))
        iters.append({"seconds": secs, "metrics": m, "phases": rows})
        if it == ZERO_NCCL_ITERS - 1:     # phase 15 holds ZeRO's to it
            trained_fp = _trained_fingerprint(tr)
    if not all(torch.equal(a, b.cpu()) for a, b in
               zip(frozen, leaves([tr.ref_params, tr.reward_params]))):
        raise SystemExit("separate: the reference or reward model moved")
    still = _unmoved(tr, trained)
    log(f"[smoke] separate launches per iteration {launches} (want {want}); "
        f"ref and reward unchanged, every actor and critic leaf given a "
        f"gradient and moved but " + ", ".join(
            f"{v} {k} norm scales" for k, v in still.items()))
    out = {"iterations": iters, "launches": launches,
           "weights_bytes": weights, "requested_bytes": asked,
           "tree_bytes": tree_bytes,
           "tree_bytes_by_name": {k: tree_nbytes(v) for k, v in trees.items()},
           "unmoved": still, "trained": trained_fp}
    if profile:
        prompts = _sep_prompts(dev, 9, actor_cfg.vocab_size)
        out["profile"], out["profile_table"] = profile_call(
            lambda: tr.train_step(prompts, g))
    del tr, trees, frozen, trained
    gc.collect()
    torch.cuda.empty_cache()

    tr, weights, _ = _separate_trainer(dev, "none")
    _, _, _, recs = _run_ppo(tr, _sep_prompts(dev, 1, actor_cfg.vocab_size),
                             g, want, "separate, policy none", 7)
    out["policy_none"] = _phase_rows(recs, weights)
    _print_phases("separate iteration, memory_policy=none",
                  out["policy_none"], log)
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # the repo's alleviation at the same shape: one hydra iteration of the
    # actor's config (rank 128, the reward adapter scoring)
    rl = RLHFConfig(engine="hydra", lora_rank=128, **SEP_KW)
    tr, weights, asked = _fresh(lambda: RLHFTrainer(
        actor_cfg, actor_cfg, rl,
        torch.Generator(device=dev).manual_seed(0)))
    secs, _, hydra_launches, recs = _run_ppo(
        tr, _sep_prompts(dev, 1, actor_cfg.vocab_size), g,
        ppo_launches(actor_cfg, rl, model_reward=True), "hydra opt_1_3b", 8)
    out["hydra"] = {"seconds": secs, "weights_bytes": weights,
                    "requested_bytes": asked,
                    "launches": hydra_launches,
                    "phases": _phase_rows(recs, weights),
                    "accounting": tr.engine.memory_accounting()}
    _print_phases(f"hydra {SEP_ACTOR} iteration ({secs * 1e3:.1f} ms; "
                  f"persistent {weights / 1e9:.3f} GB)",
                  out["hydra"]["phases"], log)
    log(f"[smoke] hydra {SEP_ACTOR} launches {hydra_launches}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # the reference's accounting of llama3_2_3b: its separate layout does
    # not fit one 80 GB card before any activation
    eng, _, _ = _fresh(lambda: ModelEngine(
        get_config("llama3_2_3b"), torch.Generator(device=dev).manual_seed(0),
        rank=128))
    acc = eng.memory_accounting()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    out["llama3_2_3b_accounting"] = acc
    for layout, gb in _accounting_gb(acc).items():
        log(f"[smoke] llama3_2_3b {layout}: params + AdamW state "
            f"{gb['state']:.2f} GB, fp32 grads of the trained roles "
            f"{gb['grad']:.2f} GB (memory_accounting)")
    out["small_model"] = check_small_ppo_against_cpu(dev, engine="separate")
    log(f"[smoke] small separate PPO card vs CPU: greedy tokens identical, "
        f"metrics max_err {out['small_model']['max_err']:.3e}")
    return out


# ---------------------------------------------------------------- phase 9
# the offload levels phase 9 runs on the separate OPT pair (``none`` is the
# baseline, run twice to see whether the card repeats itself bit for bit)
OFFLOAD_RUNS = ("optimizer", "roles", "all")
REMAT_RUNS = ("full", "offload", "dots")


def meminfo() -> dict:
    """The host's MemTotal and MemAvailable in bytes (``/proc/meminfo``)."""
    out = {}
    for line in pathlib.Path("/proc/meminfo").read_text().splitlines():
        key, val = line.split(":", 1)
        if key in ("MemTotal", "MemAvailable"):
            out[key] = int(val.split()[0]) * 1024
    return out


def link_rate(dev) -> dict:
    """A 1 GiB copy each way between the card and pinned host memory (the
    parking lot's own kind of buffer), timed with CUDA events: the link's
    yardstick; the bound of a park or fetch is its bytes over this rate."""
    n = 1 << 30
    host = pinned_buffer(n)
    d = torch.empty(n, dtype=torch.uint8, device=dev)
    d2h = time_ms(lambda: host.copy_(d, non_blocking=True), iters=5, warmup=1)
    h2d = time_ms(lambda: d.copy_(host, non_blocking=True), iters=5, warmup=1)
    del host, d
    torch.cuda.empty_cache()
    return {"bytes": n, "d2h_ms": d2h, "h2d_ms": h2d,
            "d2h_GBps": n / d2h / 1e6, "h2d_GBps": n / h2d / 1e6}


def _offload_rows(records, state_bytes, parked_at_start):
    """Per record: ms, park and fetch ms, GB moved and GB/s each way,
    live/reserved/peak/host MiB, and the persistent state resident on the
    card during the phase the record closes (GB: the state less what the
    lot held from the last fetch to this park; a sample's, at its own
    point)."""
    rows, parked = [], parked_at_start
    for r in records:
        sample = bool(r.get("sample"))
        held = r["host_bytes"] if sample else parked
        ps, fs = r.get("park_seconds", 0.0), r.get("fetch_seconds", 0.0)
        pb, fb = r.get("park_bytes", 0), r.get("fetch_bytes", 0)
        rows.append({
            "phase": r["phase"] + (" (sample)" if sample else ""),
            "ms": r["seconds"] * 1e3, "park_ms": ps * 1e3,
            "fetch_ms": fs * 1e3, "hygiene_ms":
            r.get("hygiene_seconds", 0.0) * 1e3,
            "park_GB": pb / 1e9, "fetch_GB": fb / 1e9,
            "park_GBps": pb / ps / 1e9 if pb else None,
            "fetch_GBps": fb / fs / 1e9 if fb else None,
            "live_mib": r["live_bytes"] / 2**20,
            "reserved_mib": r["reserved_bytes"] / 2**20,
            "peak_mib": r["peak_bytes"] / 2**20,
            "host_mib": r["host_bytes"] / 2**20,
            "resident_state_GB": (state_bytes - held) / 1e9})
        if not sample:
            parked = r["host_bytes"] - fb
    return rows


def _print_offload(label, rows, log):
    log(f"[smoke] {label}: phase ms (park, fetch, hygiene) / GB parked, "
        f"fetched (GB/s) / MiB live, reserved, peak, host / state on the "
        f"card GB")
    rate = lambda v: "   -  " if v is None else f"{v:6.2f}"  # noqa: E731
    for r in rows:
        log(f"  {r['phase']:25s} {r['ms']:8.1f} ({r['park_ms']:6.1f}, "
            f"{r['fetch_ms']:6.1f}, {r['hygiene_ms']:6.1f}) "
            f"{r['park_GB']:6.3f} ({rate(r['park_GBps'])}) "
            f"{r['fetch_GB']:6.3f} ({rate(r['fetch_GBps'])}) "
            f"{r['live_mib']:9.1f} {r['reserved_mib']:9.1f} "
            f"{r['peak_mib']:9.1f} {r['host_mib']:9.1f} "
            f"{r['resident_state_GB']:7.3f}")


def _bits(tree):
    """A CPU copy of every tensor of ``tree``, as raw bytes."""
    return [t.detach().to("cpu", copy=True).contiguous().view(torch.uint8)
            for t in leaves(tree)]


def _offload_run(dev, engine, level, policy, want, log, seed=0, iters=2):
    """A fresh trainer at ``level`` (the separate OPT pair, or hydra
    llama3_2_3b at phase 7's shape) and ``iters`` iterations of it (the
    first warm), each asserted (``_run_ppo``). Right after construction
    (whose ``start()`` parks) the allocator must have been asked for
    exactly the ``nbytes`` of the trees left on the card, and the lot must
    hold the managed rest."""
    if engine == "separate":
        acfg, ccfg = _study_pair()
        rl = RLHFConfig(engine="separate", memory_policy=policy,
                        offload=level, **SEP_KW)
        prompts = [_sep_prompts(dev, 1 + i, acfg.vocab_size)
                   for i in range(iters)]
        n_rec = 7
    else:
        acfg = ccfg = get_config("llama3_2_3b")
        rl = RLHFConfig(memory_policy=policy, offload=level, **PPO_KW)
        data = PromptDataset(synthetic_instruction_prompts(
            PBATCH * iters, seed=1), PPROMPT).batches(PBATCH, seed=1)
        prompts = [torch.from_numpy(next(data) % acfg.vocab_size).long()
                   .to(dev) for _ in range(iters)]
        n_rec = 8
    tr, alloc, asked = _fresh(lambda: RLHFTrainer(
        acfg, ccfg, rl, torch.Generator(device=dev).manual_seed(seed)))
    # (no reference to a tree may outlive this line: a parked tree's
    # device bytes come back only when the last one goes)
    state = sum(tree_nbytes(v) for v in tr.persistent_trees().values())
    lot = tr.offload_lot
    parked = 0 if lot is None else lot.parked_bytes()
    if lot is not None:
        plan = tr.offload.plan
        rest = plan.managed - plan.resident_for(plan.sequence[0])
        want_parked = sum(tree_nbytes(tr.offload.states[n][0]())
                          for n in rest)
        if parked != want_parked or set(lot.names()) != rest:
            raise SystemExit(f"{engine} {level}: the lot holds "
                             f"{lot.names()} ({parked} bytes), the plan "
                             f"parks {sorted(rest)} ({want_parked})")
    if asked != state - parked:
        raise SystemExit(f"{engine} {level}: {asked} bytes asked of the "
                         f"allocator after start(), {state - parked} on "
                         f"the card ({state} of state, {parked} parked)")
    g = torch.Generator(device=dev).manual_seed(7)
    out = {"level": level, "policy": policy, "state_bytes": state,
           "requested_after_start": asked, "allocated_after_start": alloc,
           "parked_after_start": parked}
    for it in range(iters):
        start = 0 if lot is None else lot.parked_bytes()
        secs, m, launches, recs = _run_ppo(
            tr, prompts[it], g, want, f"{engine} offload={level} "
            f"policy={policy} iteration {it}", n_rec)
    out.update(seconds=secs, metrics=m, launches=launches,
               records=[dict(r) for r in recs],
               rows=_offload_rows(recs, state, start))
    if lot is not None:
        out["pinned_bytes"] = lot.pinned_bytes()
        out["peak_parked_bytes"] = lot.stats.peak_parked_bytes
    return tr, out


def _same_or_within(got, a, b):
    """``got`` equals run ``a``'s metrics bit for bit when runs ``a`` and
    ``b`` (the same seed, no offload) agree bit for bit; otherwise each
    metric lies within their spread of one of them."""
    if a == b:
        return got == a
    return all(min(abs(got[k] - a[k]), abs(got[k] - b[k])) <=
               abs(a[k] - b[k]) for k in a)


def _remat_grads(tr, dev, log):
    """One actor step's forward and backward at 8 x 576 on a hydra
    llama3_2_3b trainer under each remat, from the same adapter, trunk
    and experience: the adapter's gradients, ms, peak MiB above what was
    allocated, and the launches (the AdamW update after it is the same
    for every remat)."""
    cfg = tr.actor_cfg
    g = torch.Generator(device=dev).manual_seed(11)
    B, S = PBATCH, PPROMPT + GEN
    mask = torch.zeros(B, S, device=dev)
    mask[:, PPROMPT:] = 1
    flat = torch.full((B, S), -math.log(cfg.vocab_size), device=dev)
    exp = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                   device=dev),
           "loss_mask": mask, "old_logp": flat * mask, "ref_logp": flat * mask,
           "advantages": torch.randn(B, S, generator=g, device=dev) * mask}
    adapter = tr.actor_state["params"]
    out = {}
    for remat in ("full",) + REMAT_RUNS:      # the first "full" warms up
        model = Model(dataclasses.replace(cfg, remat=remat), device=dev)
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        with torch.enable_grad():
            logits = model.forward(tr.base_params, exp, adapter=adapter)[0]
            loss, _ = TS.ppo_actor_loss(logits, exp, kl_coef=0.1)
            del logits
            grads = torch.autograd.grad(loss, list(leaves(adapter)))
        torch.cuda.synchronize()
        out[remat] = {"ms": (time.perf_counter() - t0) * 1e3,
                      "peak_mib": (torch.cuda.max_memory_allocated() - before)
                      / 2**20, "launches": dict(ops.launches),
                      "loss": float(loss.detach()), "grads": grads}
    full = out["full"]["grads"]
    if not all(torch.equal(a, b) for a, b in zip(out["offload"]["grads"],
                                                  full)):
        raise SystemExit("remat offload: gradients differ from full")
    err = max(scaled_err(a, b) for a, b in zip(out["dots"]["grads"], full))
    if not err <= TOL[torch.bfloat16]:
        raise SystemExit(f"remat dots: gradients {err} from full")
    if any(out[r]["launches"] != out["full"]["launches"] for r in REMAT_RUNS):
        raise SystemExit(f"remat launches differ: "
                         f"{ {r: out[r]['launches'] for r in REMAT_RUNS} }")
    for r in REMAT_RUNS:
        del out[r]["grads"]
        log(f"[smoke] remat {r:8s}: actor fwd + bwd {out[r]['ms']:8.1f} ms, "
            f"peak {out[r]['peak_mib']:8.1f} MiB above the state, loss "
            f"{out[r]['loss']:.6f}")
    log(f"[smoke] remat: offload gradients bit-identical to full, dots "
        f"within {err:.3e} (tol {TOL[torch.bfloat16]}); launches "
        f"{out['full']['launches']} under each")
    return {r: out[r] for r in REMAT_RUNS} | {"dots_max_err": err}


def offload_ppo(dev, log):
    """Phase 9: host offload on the card. (a) The separate OPT pair at
    phase 8's shape: the same-seed ``none`` iteration twice, then a fresh
    trainer at each of ``optimizer``, ``roles`` and ``all`` under
    ``after_inference`` and one at ``roles`` under ``none`` (no
    ``empty_cache``: parked bytes leave ``memory_allocated`` but stay
    reserved); each a warm iteration and a measured one, asserted: the
    bytes left on the card after ``start()``, launches (``ppo_launches``),
    metrics equal to ``none`` (bit for bit if ``none`` repeats itself,
    else within its spread), the reference and reward models bit for bit,
    and every record's live bytes below ``none``'s by at least the bytes
    parked there. (b) Hydra llama3_2_3b at ``all`` (phase 7's shape): the
    rollout's mid-phase sample below ``none``'s by at least the trunk's
    adapted leaves. (c) One actor step's forward and backward on that
    trainer under remat "full", "offload" and "dots". And the link's
    yardstick: a 1 GiB pinned copy each way."""
    out = {"meminfo_before": meminfo(), "link": link_rate(dev)}
    ln = out["link"]
    log(f"[smoke] offload: host {out['meminfo_before']}; 1 GiB pinned copy "
        f"D2H {ln['d2h_ms']:.2f} ms ({ln['d2h_GBps']:.2f} GB/s), H2D "
        f"{ln['h2d_ms']:.2f} ms ({ln['h2d_GBps']:.2f} GB/s)")
    acfg, ccfg = _study_pair()
    want = ppo_launches(acfg, RLHFConfig(engine="separate", **SEP_KW),
                        model_reward=True, critic_cfg=ccfg)
    runs, frozen = {}, None
    for key, level, policy in ([("none", "none", "after_inference"),
                                ("none_again", "none", "after_inference")]
                               + [(lv, lv, "after_inference")
                                  for lv in OFFLOAD_RUNS]
                               + [("roles_policy_none", "roles", "none")]):
        tr, run = _offload_run(dev, "separate", level, policy, want, log)
        bits = _bits([tr.ref_params, tr.reward_params])
        if frozen is None:
            frozen = bits
        elif not all(torch.equal(a, b) for a, b in zip(bits, frozen)):
            raise SystemExit(f"separate offload={level}: the reference or "
                             "reward model changed")
        del tr, bits
        gc.collect()
        torch.cuda.empty_cache()
        run["mem_available_after"] = meminfo()["MemAvailable"]
        runs[key] = run
        _print_offload(f"separate offload={level} policy={policy} "
                       f"({run['seconds'] * 1e3:.1f} ms)", run["rows"], log)
    a, b = runs["none"]["metrics"], runs["none_again"]["metrics"]
    out["none_repeats_bitwise"] = a == b
    out["none_spread"] = {k: abs(a[k] - b[k]) for k in a}
    log(f"[smoke] separate none twice: bit for bit {a == b}; spread "
        f"{out['none_spread']}")
    for key, run in runs.items():
        if key.startswith("none"):
            continue
        if not _same_or_within(run["metrics"], a, b):
            raise SystemExit(f"separate {key}: metrics {run['metrics']} "
                             f"against none {a}, {b}")
        for r0, r in zip(runs["none"]["records"], run["records"]):
            if r0["live_bytes"] - r["live_bytes"] < r["host_bytes"]:
                raise SystemExit(f"separate {key} {r['phase']}: live "
                                 f"{r['live_bytes']} against none's "
                                 f"{r0['live_bytes']}, {r['host_bytes']} "
                                 "parked")
        if run["policy"] == "none" and min(
                r["reserved_bytes"] for r in run["records"]) < \
                run["state_bytes"]:
            raise SystemExit(f"separate {key}: reserved fell below the "
                             "state without empty_cache")
        log(f"[smoke] separate {key}: metrics "
            f"{'bit for bit' if a == b else 'within the spread of'} none's; "
            f"{run['requested_after_start']} bytes on the card after "
            f"start(), {run['parked_after_start']} parked; pinned "
            f"{run['pinned_bytes']} bytes for a parked peak of "
            f"{run['peak_parked_bytes']}")
    out["separate"] = runs

    # (b) hydra llama3_2_3b at "all": the trunk's adapted leaves parked
    # while the merged copy serves rollout
    cfg = get_config("llama3_2_3b")
    want_h = ppo_launches(cfg, RLHFConfig(**PPO_KW), model_reward=True)
    tr, none_run = _offload_run(dev, "hydra", "none", "after_inference",
                                want_h, log)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    tr, all_run = _offload_run(dev, "hydra", "all", "after_inference",
                               want_h, log)
    adapted = tree_nbytes(LORA.adapted_subtree(tr.base_params,
                                               tr.engine.lora_sites()))
    drop = none_run["records"][0]["live_bytes"] - \
        all_run["records"][0]["live_bytes"]
    if all_run["records"][0]["phase"] != "rollout_decode" or drop < adapted:
        raise SystemExit(f"hydra all: the rollout sample is {drop} bytes "
                         f"below none's, the adapted leaves {adapted}")
    _print_offload("hydra llama3_2_3b offload=none", none_run["rows"], log)
    _print_offload(f"hydra llama3_2_3b offload=all "
                   f"({all_run['seconds'] * 1e3:.1f} ms)", all_run["rows"],
                   log)
    log(f"[smoke] hydra all: rollout sample {drop} bytes below none's "
        f"(the adapted leaves: {adapted})")
    out["hydra"] = {"none": none_run, "all": all_run,
                    "adapted_bytes": adapted, "sample_drop_bytes": drop}

    # (c) remat on the same trainer
    out["remat"] = _remat_grads(tr, dev, log)
    del tr, frozen
    gc.collect()
    torch.cuda.empty_cache()
    out["meminfo_after"] = meminfo()
    log(f"[smoke] offload: host MemAvailable after each separate run "
        f"{[r['mem_available_after'] for r in runs.values()]}, at the end "
        f"{out['meminfo_after']}")
    out["launches"] = runs["roles"]["launches"]
    out["hydra_launches"] = all_run["launches"]
    return out


# ---------------------------------------------------------------- phase 10
def _decode_call(ro, run, graphs, temperature, n):
    """One generate call of ``n`` new tokens through ``ro``, graphed or
    eager: ((tokens, log-probs) on the host, synchronised host seconds,
    launches from 0, live bytes after it with its result dropped, its
    decode stats)."""
    ro._graphs, ro.temperature = graphs, temperature
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = run(n)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    bits = (res.tokens.cpu(), res.logp.cpu())
    del res
    st = dict(ro.decode_stats)
    # a call captures only where a replay follows: two decode steps or more
    if st["graphed"] != (graphs and n >= 3):
        raise SystemExit(f"asked graphed={graphs}, ran {st}")
    return (bits, secs, dict(ops.launches), torch.cuda.memory_allocated(),
            st)


def _same_bits(a, b) -> bool:
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def decode_graph_path(label, ro, run, gen, log):
    """One decode path graphed against eager, from one seed, in this call:
    sampled at the path's temperature in turns (eager, graphed, graphed,
    eager: the host clock moves between calls) and greedy (graphed,
    eager). Fails unless every call gives the same tokens and log-probs
    (per temperature), the same launches and the same live bytes after
    it, and every graphed step after the first is a replay. ms a decode
    step: (call - prefill call) / (gen - 1), the prefill call being the
    same call with one new token (no decode step); graphed with the
    capture in it, and without it. The paged path's host time a step is
    split between the page manager and the rest (dispatch and sampling).
    ``run(n)`` makes one call of n new tokens from the path's seed."""
    temp = ro.temperature
    sampled = [_decode_call(ro, run, g, temp, gen)
               for g in (False, True, True, False)]
    greedy = [_decode_call(ro, run, g, 0.0, gen) for g in (True, False)]
    pre = _decode_call(ro, run, True, temp, 1)
    ro._graphs, ro.temperature = True, temp
    calls = sampled + greedy
    for name, group in (("sampled", sampled), ("greedy", greedy)):
        if not all(_same_bits(c[0], group[0][0]) for c in group):
            raise SystemExit(f"{label}: {name} tokens or log-probs differ "
                             f"graphed vs eager")
    if any(c[2] != calls[0][2] for c in calls):
        raise SystemExit(f"{label}: launches differ graphed vs eager: "
                         f"{[c[2] for c in calls]}")
    if any(c[3] != calls[0][3] for c in calls):
        raise SystemExit(f"{label}: live bytes after the call differ: "
                         f"{[c[3] for c in calls]}")
    for c in calls:
        st = c[4]
        if st["replays"] != (gen - 2 if st["graphed"] else 0) or \
                (st["graphed"] and st["capture_ms"] is None):
            raise SystemExit(f"{label}: not every graphed step after the "
                             f"first was a replay: {st}")
    gst = sampled[1][4]
    eager_s = (sampled[0][1] + sampled[3][1]) / 2
    graph_s = (sampled[1][1] + sampled[2][1]) / 2
    cap_ms = (sampled[1][4]["capture_ms"] + sampled[2][4]["capture_ms"]) / 2
    per = lambda s: (s - pre[1]) * 1e3 / (gen - 1)  # noqa: E731
    out = {"path": label, "gen": gen, "same_sampled_bits": True,
           "same_greedy_bits": True, "launches": calls[0][2],
           "live_bytes_after": calls[0][3],
           "call_ms": {"eager": [sampled[0][1] * 1e3, sampled[3][1] * 1e3],
                       "graphed": [sampled[1][1] * 1e3,
                                   sampled[2][1] * 1e3]},
           "prefill_call_ms": pre[1] * 1e3,
           "eager_step_ms": per(eager_s), "graphed_step_ms": per(graph_s),
           "graphed_step_ms_without_capture": per(graph_s - cap_ms / 1e3),
           "capture_ms": cap_ms, "pool_mib": gst["pool_bytes"] / 2**20,
           "greedy_step_ms": {"graphed": per(greedy[0][1]),
                              "eager": per(greedy[1][1])},
           "host_ms_a_step": {
               "eager": sampled[0][4]["host_ms"] / (gen - 1),
               "graphed": gst["host_ms"] / (gen - 1)},
           "greedy_host_ms_a_step": {
               "graphed": greedy[0][4]["host_ms"] / (gen - 1),
               "eager": greedy[1][4]["host_ms"] / (gen - 1)},
           "page_manager_ms_a_step": {
               "eager": sampled[0][4]["page_manager_ms"] / (gen - 1),
               "graphed": gst["page_manager_ms"] / (gen - 1)}}
    log(f"[smoke] decode graph {label}: tokens and log-probs the same bits "
        f"graphed and eager (sampled at T {temp}, and greedy); launches "
        f"equal {calls[0][2]}; live after {calls[0][3] / 2**20:.1f} MiB "
        f"both ways")
    log(f"[smoke]   ms a decode step: eager {out['eager_step_ms']:.3f}, "
        f"graphed {out['graphed_step_ms']:.3f} "
        f"({out['graphed_step_ms_without_capture']:.3f} without the "
        f"capture); capture {cap_ms:.1f} ms, pool {out['pool_mib']:.1f} MiB"
        f"; calls eager "
        f"{sampled[0][1] * 1e3:.1f} / {sampled[3][1] * 1e3:.1f} ms, graphed "
        f"{sampled[1][1] * 1e3:.1f} / {sampled[2][1] * 1e3:.1f} ms, prefill "
        f"call {pre[1] * 1e3:.1f} ms")
    hm, pm = out["host_ms_a_step"], out["page_manager_ms_a_step"]
    gs, gh = out["greedy_step_ms"], out["greedy_host_ms_a_step"]
    log(f"[smoke]   host ms a step in the loop (sampled; the sampler's "
        f"validity check waits for the card): eager {hm['eager']:.3f} "
        f"(page manager {pm['eager']:.3f}), graphed {hm['graphed']:.3f} "
        f"(page manager {pm['graphed']:.3f}); greedy (no wait in the "
        f"loop): ms a step eager {gs['eager']:.3f}, graphed "
        f"{gs['graphed']:.3f}, of which the loop's host ms eager "
        f"{gh['eager']:.3f}, graphed {gh['graphed']:.3f}")
    return out


def _trainer_run(tr, prompts, seed):
    """``run(n)`` for a trainer's rollout phase (``_gen``: the hydra
    engine's merged weights, or the separate actor's)."""
    gen_len = tr.rl.gen_len

    def run(n):
        tr.rl.gen_len = n
        try:
            return tr._gen(prompts, torch.Generator(
                device=prompts.device).manual_seed(seed))
        finally:
            tr.rl.gen_len = gen_len
    return run


def _iterations_both_ways(tr, prompts, want, label, log):
    """One PPO iteration eager, then one graphed, on the same trainer:
    iteration and rollout ms, and the rollout boundary's live bytes (the
    adapters move between the two, so this times, it does not compare
    bits); launches asserted both ways."""
    g = torch.Generator(device=prompts.device).manual_seed(11)
    out = {}
    n = 8 if tr.engine is not None else 7
    for graphs in (False, True):
        tr.rollout._graphs = graphs
        secs, _, _, recs = _run_ppo(tr, prompts, g, want,
                                    f"{label} graphed={graphs}", n)
        ro = [r for r in recs if r["phase"] == "rollout"][0]
        dec = [r for r in recs if r["phase"] == "rollout_decode"]
        out["graphed" if graphs else "eager"] = {
            "seconds": secs, "rollout_ms": (ro["seconds"] + sum(
                r["seconds"] for r in dec)) * 1e3,
            "rollout_live_bytes": ro["live_bytes"]}
    tr.rollout._graphs = True
    e, gr = out["eager"], out["graphed"]
    log(f"[smoke]   {label} iteration: eager {e['seconds'] * 1e3:.1f} ms "
        f"(rollout {e['rollout_ms']:.1f}), graphed "
        f"{gr['seconds'] * 1e3:.1f} ms (rollout {gr['rollout_ms']:.1f}); "
        f"live at the rollout boundary {e['rollout_live_bytes']} / "
        f"{gr['rollout_live_bytes']} bytes")
    if e["rollout_live_bytes"] != gr["rollout_live_bytes"]:
        raise SystemExit(f"{label}: live bytes at the rollout boundary "
                         f"differ graphed vs eager")
    return out


def profiled_call(label, ro, run, graphs, log):
    """One profiled call of ``GEN`` new tokens through ``ro``, graphed or
    eager. The first-kind kernels the trace holds, per wrapper, must equal
    ``ops.launches`` for the call: on a graphed call those counts are the
    capture's record added once a replay, so this holds them to what the
    card ran."""
    ro._graphs = graphs
    ops.reset_launches()
    prof, _ = profile_call(lambda: run(GEN))
    want = {w: ops.launches[w] for w in KERNEL_FUNCS}
    seen = {w: prof["port"].get(w, {}).get("calls", 0) for w in KERNEL_FUNCS}
    if seen != want:
        raise SystemExit(f"{label}: kernels in the trace {seen} differ from "
                         f"ops.launches {want}")
    print_profile(label, prof)
    log(f"[smoke]   {label}: the trace's kernels equal ops.launches "
        f"{ {w: n for w, n in want.items() if n} }")
    return prof


def decode_graphs(dev, log, profile=False):
    """Phase 10: every decode path eagerly and graphed in this call, from
    one seed (``decode_graph_path``): serving llama3_2_3b 8 x (512 + 64),
    the paged GRPO rollout (8 prompts x 504, G = 8, 64 generated), Mamba2
    mamba2_370m 8 x (2048 + 64), the hydra PPO rollout of llama3_2_3b 8 x
    (512 + 64) and the separate PPO rollout of opt_1_3b 8 x (256 + 256);
    for the two PPO paths also one iteration each way. With ``profile``,
    the device's idle share over a graphed and an eager serving call."""
    out = {}
    cfg = get_config("llama3_2_3b")
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    ids = torch.from_numpy(next(PromptDataset(synthetic_instruction_prompts(
        BATCH, seed=0), PROMPT).batches(BATCH, seed=0)) % cfg.vocab_size
    ).long().to(dev)
    ro = Rollout(model, cfg, capacity=PROMPT + GEN, temperature=0.8,
                 top_k=serve.TOP_K)
    run = lambda n: ro.generate(  # noqa: E731
        params, {"tokens": ids}, n, torch.Generator(device=dev).manual_seed(1))
    out["serve"] = decode_graph_path("serve llama3_2_3b", ro, run, GEN, log)
    if profile:
        for graphs in (True, False):
            key = "profile_graphed" if graphs else "profile_eager"
            prof = profiled_call(f"serving request, {key[8:]}", ro, run,
                                 graphs, log)
            out["serve"][key] = {k: prof[k] for k in (
                "profiled_wall_s", "kernel_busy_s", "idle_share")}
        ro._graphs = True

    gids = torch.from_numpy(next(PromptDataset(synthetic_instruction_prompts(
        GROUPS, seed=0), GPROMPT).batches(GROUPS, seed=0)) % cfg.vocab_size
    ).long().to(dev)
    pro = Rollout(model, cfg, capacity=GPROMPT + GEN, backend="paged",
                  page_size=PAGE, temperature=0.8, top_k=serve.TOP_K)
    prun = lambda n: pro.generate(  # noqa: E731
        params, {"tokens": gids}, n,
        torch.Generator(device=dev).manual_seed(1), group_size=GSIZE)
    out["paged_grpo"] = decode_graph_path("paged GRPO llama3_2_3b", pro,
                                          prun, GEN, log)
    log("[smoke] decode graphs: B3's combine and B4's merge were captured "
        "with their programmatic dependent launch (a toolkit that refused "
        "it would fail the capture)")
    if profile:
        prof = profiled_call("paged GRPO request, graphed", pro, prun, True,
                             log)
        out["paged_grpo"]["profile_graphed"] = {k: prof[k] for k in (
            "profiled_wall_s", "kernel_busy_s", "idle_share")}
    del model, params, ro, pro
    gc.collect()
    torch.cuda.empty_cache()

    mcfg = get_config("mamba2_370m")
    model = Model(mcfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    mids = torch.randint(0, mcfg.vocab_size, (MBATCH, MPROMPT), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    ro = Rollout(model, mcfg, capacity=MPROMPT + GEN, temperature=0.8,
                 top_k=serve.TOP_K)
    run = lambda n: ro.generate(  # noqa: E731
        params, {"tokens": mids}, n,
        torch.Generator(device=dev).manual_seed(1))
    out["mamba"] = decode_graph_path("mamba2 mamba2_370m", ro, run, GEN, log)
    del model, params, ro
    gc.collect()
    torch.cuda.empty_cache()

    tr, _ = _trainer(cfg, dev, "after_inference")
    prompts = torch.from_numpy(next(PromptDataset(
        synthetic_instruction_prompts(PBATCH, seed=1), PPROMPT).batches(
            PBATCH, seed=1)) % cfg.vocab_size).long().to(dev)
    out["ppo_hydra"] = decode_graph_path(
        "hydra PPO rollout llama3_2_3b", tr.rollout,
        _trainer_run(tr, prompts, 3), GEN, log)
    out["ppo_hydra"]["iterations"] = _iterations_both_ways(
        tr, prompts, ppo_launches(cfg, tr.rl, model_reward=True),
        "hydra PPO", log)
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    tr, _, _ = _separate_trainer(dev, "after_inference")
    prompts = _sep_prompts(dev, 1, tr.actor_cfg.vocab_size)
    out["ppo_separate"] = decode_graph_path(
        "separate PPO rollout opt_1_3b", tr.rollout,
        _trainer_run(tr, prompts, 3), SGEN, log)
    out["ppo_separate"]["iterations"] = _iterations_both_ways(
        tr, prompts, ppo_launches(tr.actor_cfg, tr.rl, model_reward=True,
                                  critic_cfg=tr.critic_cfg),
        "separate PPO", log)
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # what one capture stream costs for the process: cuBLAS's workspace
    # for a stream it has not run on yet (one more stream, measured here)
    a = torch.randn(64, 64, device=dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        y = a @ a
    side.synchronize()
    out["stream_workspace_bytes"] = torch.cuda.memory_allocated() - before \
        - y.numel() * y.element_size()
    log(f"[smoke] decode graphs: the capture stream's cuBLAS workspace, "
        f"allocated once a process: {out['stream_workspace_bytes']} bytes")
    del y, a
    return out


# ---------------------------------------------------------------- phase 11
# entries the caching allocator's history keeps (an eager separate
# iteration makes ~2e5); recorded with no stack context
HISTORY_ENTRIES = 2_000_000
# GRPO at build_grpo_phases' own shape: 2 prompts x G 8, 256 + 256, paged
GR_PROMPTS, GR_GROUP, GR_ITERS = 2, 8, 2
MIB = 2**20


def _empties(policy, kind) -> bool:
    """Whether ``policy`` runs ``empty_cache`` at a boundary of ``kind``."""
    return policy == "after_all" or policy == f"after_{kind}"


def record_stream(run):
    """``run()`` with the caching allocator's history on (no stack
    context) -> (its result, the blocks live when recording began as
    (address, requested bytes), the bytes reserved then, and the trace's
    alloc / free_completed / segment_alloc / segment_free entries since,
    in order, as (action, address, bytes, time_us, stream)). The trace's
    sizes are the requested (unrounded) bytes, its times the host's
    microseconds since the epoch (checked on torch 2.11 before this
    relied on them)."""
    torch.cuda.synchronize()
    t0 = time.time_ns() // 1000
    torch.cuda.memory._record_memory_history(
        enabled="all", context=None, stacks="python",
        max_entries=HISTORY_ENTRIES)
    try:
        start = torch.cuda.memory._snapshot()
        out = run()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    dev = torch.cuda.current_device()
    trace = snap["device_traces"][dev]
    if len(trace) >= HISTORY_ENTRIES:
        raise SystemExit("memory history full: raise HISTORY_ENTRIES")
    segs = [s for s in start["segments"] if s["device"] == dev]
    seeds = [(b["address"], b["requested_size"]) for s in segs
             for b in s["blocks"] if b["state"] in (
                 "active_allocated", "active_pending_free")]
    keep = ("alloc", "free_completed", "segment_alloc", "segment_free")
    events = [(e["action"], e["addr"], e["size"], e["time_us"], e["stream"])
              for e in trace if e["action"] in keep and e["time_us"] >= t0]
    return out, seeds, sum(s["total_size"] for s in segs), events


def _block(nb: int) -> int:
    """The caching allocator's block for a request: 512-byte multiples."""
    return max(512, -(-nb // 512) * 512)


def replay_stream(seeds, reserved0, events, records, policy, capacity):
    """The card's recorded stream through ``core.CachingAllocator`` (the
    reference's model, at the card's ``capacity``), seeded with the blocks
    live when recording began, with ``empty_cache`` at the boundaries
    ``policy`` names (before the record, as the runtime does). Per
    boundary record: the stream's live requested bytes, the card's
    reserved bytes from its segment events and its cudaMallocs in the
    phase, and the replay's allocated and reserved bytes and cudaMallocs.
    Over the stream: the card's peak reserved and its fragmentation when
    it was set (reserved less the live blocks rounded as the allocator
    rounds, at the cudaMalloc that set it), the streams seen, and the
    replay's peak reserved, fragmentation at peak and cudaMallocs."""
    sim = CachingAllocator(capacity=capacity)
    handles, live, blocks = {}, 0, 0
    for addr, nb in seeds:
        handles[addr] = (sim.malloc(nb), nb)
        live, blocks = live + nb, blocks + _block(nb)
    sim0 = sim.stats.n_cuda_malloc
    reserved = peak = reserved0
    frag = reserved0 - blocks
    rows, mallocs, streams, i = [], 0, set(), 0
    last_sim = sim.stats.n_cuda_malloc

    def boundary(rec):
        nonlocal mallocs, last_sim
        if _empties(policy, rec["kind"]):
            sim.empty_cache()
        rows.append({"phase": rec["phase"], "stream_live": live,
                     "card_requested": rec["requested_bytes"],
                     "card_reserved_from_stream": reserved,
                     "card_reserved": rec["reserved_bytes"],
                     "card_mallocs": mallocs,
                     "replay_allocated": sim.allocated,
                     "replay_reserved": sim.reserved,
                     "replay_mallocs": sim.stats.n_cuda_malloc - last_sim})
        mallocs, last_sim = 0, sim.stats.n_cuda_malloc

    for act, addr, size, t, stream in events:
        while i < len(records) and t > records[i]["t"] * 1e6:
            boundary(records[i])
            i += 1
        streams.add(stream)
        if act == "alloc":
            handles[addr] = (sim.malloc(size), size)
            live, blocks = live + size, blocks + _block(size)
        elif act == "free_completed":
            h, nb = handles.pop(addr)
            sim.free(h)
            live, blocks = live - nb, blocks - _block(nb)
        elif act == "segment_alloc":
            if reserved + size > peak:
                peak, frag = reserved + size, reserved - blocks
            reserved += size
            mallocs += 1
        else:
            reserved -= size
    while i < len(records):
        boundary(records[i])
        i += 1
    st = sim.stats
    return rows, {"card_peak_reserved": peak, "card_frag_at_peak": frag,
                  "streams": sorted(streams),
                  "replay_peak_reserved": st.peak_reserved,
                  "replay_frag_at_peak": st.frag_at_peak,
                  "replay_mallocs": st.n_cuda_malloc - sim0,
                  "replay_peak_allocated": st.peak_allocated}


def _sim_rows(result, phases):
    """The simulator's records mapped onto the runtime's boundaries
    (``RUNTIME_RLHF_PHASE_SEQUENCE``: its rollout is the simulator's
    prefill and decode, whose peak is the larger of theirs)."""
    recs = {r.name: r for r in result.phase_records}
    out = []
    for name in phases:
        if name == "rollout":
            r = recs["rollout_decode"]
            peak = max(r.alloc_peak, recs["rollout_prefill"].alloc_peak)
        else:
            r, peak = recs[name], recs[name].alloc_peak
        out.append({"phase": name, "reserved_end": r.reserved_end,
                    "allocated_end": r.allocated_end, "alloc_peak": peak,
                    "host_bytes": r.host_bytes,
                    "state_bytes_end": sum(r.state_bytes_end.values())})
    return out


def _unsliced_peak(trace) -> int:
    """A trace's peak live bytes without its ``layer_slice`` events: those
    stand for ZeRO-3's per-layer gathers, which a one-card run makes none
    of (the simulator scales them to 0 below stage 3)."""
    live = peak = 0
    for op, _, nb, tag in trace.events:
        if tag != "layer_slice":
            live += nb if op == "alloc" else -nb
            peak = max(peak, live)
    return peak


def _trace_peaks(phases):
    """Each runtime phase's trace peak without layer slices (the rollout:
    its prefill's and decode's larger)."""
    peak = {p.name: _unsliced_peak(p.trace) for p in phases}
    peak["rollout"] = max(peak.pop("rollout_prefill"),
                          peak.pop("rollout_decode"))
    return peak


def _study_run(tr, prompts, g, want, policy, label):
    """One policy on the separate trainer: a warm and a timed iteration
    (the cache as the last left it: the steady state), then the cache
    emptied and a recorded iteration (history on), so that the card and
    the replay of its stream both start with no free cached block -> the
    timed ms and records, the recorded iteration's records and its
    stream's replay."""
    tr.memory.policy = policy
    _run_ppo(tr, prompts[0], g, want, f"{label} warm", 7)
    secs, _, _, steady = _run_ppo(tr, prompts[1], g, want, f"{label} timed",
                                  7)
    steady = [dict(r) for r in steady]
    gc.collect()
    torch.cuda.empty_cache()
    (_, _, _, recs), seeds, reserved0, events = record_stream(
        lambda: _run_ppo(tr, prompts[2], g, want, f"{label} recorded", 7))
    recs = [dict(r) for r in recs]
    return {"policy": policy, "ms": secs * 1e3, "steady": steady,
            "records": recs, "n_events": len(events), "seeds": len(seeds),
            "reserved_at_start": reserved0,
            "replay": replay_stream(seeds, reserved0, events, recs, policy,
                                    torch.cuda.mem_get_info()[1])}


def _print_study(label, run, sim_rows, trace_peak, state, log):
    """Per phase of the recorded iteration: the card (live, reserved, peak
    MiB; cudaMallocs), the replay of its own stream (allocated, reserved
    MiB; cudaMallocs), and the simulator on the port's traces (allocated,
    reserved, peak MiB); then the card's peak above the state and above
    what was live when the phase began, beside the trace's peak; and the
    reserved MiB of the timed (steady-state) iteration."""
    rows, _ = run["replay"]
    log(f"[smoke] {label} ({run['ms']:.1f} ms timed): card live / reserved "
        f"/ peak MiB, cudaMallocs | replay of its stream allocated / "
        f"reserved MiB, cudaMallocs | simulator on the port's traces "
        f"allocated / reserved / peak MiB | peak MiB above the state, above "
        f"the phase's first live bytes: card, card, trace | steady reserved")
    start = run["records"][-1]["live_bytes"]
    for rec, row, sim, st in zip(run["records"], rows, sim_rows,
                                 run["steady"]):
        log(f"  {rec['phase']:15s} {rec['live_bytes'] / MIB:9.1f} "
            f"{rec['reserved_bytes'] / MIB:9.1f} {rec['peak_bytes'] / MIB:9.1f}"
            f" {row['card_mallocs']:4d} | {row['replay_allocated'] / MIB:9.1f}"
            f" {row['replay_reserved'] / MIB:9.1f} {row['replay_mallocs']:4d} "
            f"| {sim['allocated_end'] / MIB:9.1f} {sim['reserved_end'] / MIB:9.1f}"
            f" {sim['alloc_peak'] / MIB:9.1f} | "
            f"{(rec['peak_bytes'] - state) / MIB:9.1f} "
            f"{(rec['peak_bytes'] - start) / MIB:9.1f} "
            f"{trace_peak[rec['phase']] / MIB:9.1f} | "
            f"{st['reserved_bytes'] / MIB:9.1f}")
        start = rec["live_bytes"]


def grpo_launches(cfg, gen: int) -> dict:
    """Kernel launches of one GRPO iteration on the paged backend: the
    rollout (the paged prefill, B2 once a layer and B1 at 2L + 1 and once
    more for the group's replicated unembedding; B4 once a layer at each
    of the gen - 1 decode steps, B1 (2L + 1) a step), two scoring forwards
    (actor and reference: B2 L, B1 2L + 1 each), and the actor's step at
    remat "none" (its forward, B2-bwd L and B1-bwd at every norm)."""
    L = cfg.num_layers
    want = {k: 0 for k in ops.KERNELS}
    want["flash_attention"] = 4 * L
    want["paged_decode_attention"] = L * (gen - 1)
    want["rmsnorm"] = (2 * L + 1) * gen + 1 + 3 * (2 * L + 1)
    want["flash_attention_bwd"] = L
    want["rmsnorm_bwd"] = 2 * L + 1
    return want


def even_token_reward(tokens, mask):
    """The fraction of a row's generated tokens that are even: a
    programmatic reward that a random model's samples spread, so a group's
    advantages are not all zero."""
    hit = (tokens % 2 == 0).float() * mask
    return hit.sum(-1) / torch.clamp(mask.sum(-1), min=1.0)


def grpo_on_card(dev, capacity, log):
    """(f) ``GRPOTrainer`` on opt_1_3b at ``build_grpo_phases``' shape,
    paged rollout (eager decode), ``even_token_reward``, GR_ITERS
    iterations with their launches asserted (B3 never) and a gradient
    given; the last iteration's records beside ``run_iteration`` on the
    port's ``build_grpo_phases`` at that shape."""
    cfg = get_config(SEP_ACTOR)
    rl = GRPOConfig(prompt_len=SPROMPT, gen_len=SGEN, group_size=GR_GROUP,
                    kl_coef=0.02, lr=1e-5, temperature=1.0, top_k=50,
                    rollout_backend="paged", page_size=PAGE)
    tr, state, _ = _fresh(lambda: GRPOTrainer(
        cfg, rl, torch.Generator(device=dev).manual_seed(0),
        even_token_reward))
    tr.rollout._graphs = False
    want = grpo_launches(cfg, SGEN)
    g = torch.Generator(device=dev).manual_seed(7)
    its = []
    for it in range(GR_ITERS):
        prompts = _sep_prompts(dev, 20 + it, cfg.vocab_size)[:GR_PROMPTS]
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        m = tr.train_step(prompts, g)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if dict(ops.launches) != want:
            raise SystemExit(f"GRPO iteration {it}: launches "
                             f"{dict(ops.launches)} != {want}")
        if not all(math.isfinite(v) for v in m.values()) or \
                not m["grad_norm"] > 0:
            raise SystemExit(f"GRPO iteration {it}: metrics {m}")
        its.append({"ms": secs * 1e3, "metrics": m,
                    "records": [dict(r) for r in tr.memory.records[-3:]]})
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    phases, per = build_grpo_phases(cfg, batch=GR_PROMPTS,
                                    group_size=GR_GROUP, prompt_len=SPROMPT,
                                    gen_len=SGEN)
    sim = run_iteration(phases, per, MemoryStrategy("None"),
                        "after_inference", ndp=1, trainable_fraction=1.0,
                        capacity=capacity)
    recs = {r.name: r for r in sim.phase_records}
    sim_state = sum(nb for v in per.buffers.values() for nb, _ in v)
    pairs = (("rollout", "rollout_decode"), ("score", "score_old_logp"),
             ("train_actor", "train_actor"))
    log(f"[smoke] GRPO {SEP_ACTOR} paged, {GR_PROMPTS} prompts x G "
        f"{GR_GROUP}, {SPROMPT} + {SGEN}: metrics " + ", ".join(
            f"{k} {v:.4g}" for k, v in sorted(its[-1]["metrics"].items())))
    log(f"[smoke] GRPO: {its[-1]['ms']:.1f} ms, launches "
        f"{want} (B3 none); state {state / MIB:.1f} MiB on the card, "
        f"{sim_state / MIB:.1f} simulated. Per phase MiB: card live / "
        f"reserved / peak | simulator allocated / reserved / peak")
    rows = []
    for rec, (name, sname) in zip(its[-1]["records"], pairs):
        r = recs[sname]
        peak = max(r.alloc_peak, recs["rollout_prefill"].alloc_peak) \
            if name == "rollout" else r.alloc_peak
        rows.append({"phase": name, "card": {k: rec[k] for k in (
            "live_bytes", "reserved_bytes", "peak_bytes")},
            "sim": {"allocated_end": r.allocated_end,
                    "reserved_end": r.reserved_end, "alloc_peak": peak}})
        log(f"  {name:12s} {rec['live_bytes'] / MIB:9.1f} "
            f"{rec['reserved_bytes'] / MIB:9.1f} {rec['peak_bytes'] / MIB:9.1f}"
            f" | {r.allocated_end / MIB:9.1f} {r.reserved_end / MIB:9.1f} "
            f"{peak / MIB:9.1f}")
    return {"launches": want, "state_bytes": state, "sim_state": sim_state,
            "iterations": its, "rows": rows}


def memory_study(dev, log, sep, off):
    """Phase 11: the paper's memory study on the H100, the separate OPT
    pair at phase 8's shape (the reward model scoring), decode eager (the
    simulator models one pool; a graph keeps its own). (a) Per policy of
    ``POLICIES``: a warm, a timed and a recorded iteration; per phase the
    card's live, reserved and peak bytes and cudaMallocs, and the timed
    ms; one iteration at remat "full" against "none". (b) Each recorded
    iteration's own allocator stream replayed through
    ``core.CachingAllocator``; hard check: the stream's live requested
    bytes equal ``requested_bytes.all.current`` at every boundary. (c)
    ``run_iteration`` on the port's own traces (``build_rlhf_phases`` at
    this shape) under each policy, the traces' peaks beside the card's,
    and ``train_actor``'s peak broken down by tag and by op. (d) The
    simulated state on the card and on the host at every boundary of
    each offload level equal to phase 9's measured to the MiB (hard
    check). (e) R1-R3 as the card shows them beside the simulator. (f)
    GRPO on the card (``grpo_on_card``). ``sep``, ``off``: phases 8's and
    9's reports."""
    actor_cfg, critic_cfg = pair = _study_pair()
    capacity = torch.cuda.mem_get_info()[1]
    out = {"capacity": capacity}
    tr, state, _ = _separate_trainer(dev, "after_inference", pair=pair)
    tr.rollout._graphs = False
    want = ppo_launches(actor_cfg, tr.rl, model_reward=True,
                        critic_cfg=critic_cfg)
    g = torch.Generator(device=dev).manual_seed(7)
    prompts = [_sep_prompts(dev, 30 + i, actor_cfg.vocab_size)
               for i in range(3)]
    runs = {}
    for policy in POLICIES:
        runs[policy] = _study_run(tr, prompts, g, want, policy,
                                  f"memory study {policy}")
        for row in runs[policy]["replay"][0]:
            if row["stream_live"] != row["card_requested"]:
                raise SystemExit(
                    f"memory study {policy} {row['phase']}: the stream's "
                    f"live requested bytes {row['stream_live']} != "
                    f"requested_bytes.all.current {row['card_requested']}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    # R2's checkpointing half: the same pair at remat "full", against the
    # recorded after_inference iteration above (the pair's remat is "none")
    tr, _, _ = _fresh(lambda: RLHFTrainer(
        dataclasses.replace(actor_cfg, remat="full"),
        dataclasses.replace(critic_cfg, remat="full"),
        RLHFConfig(engine="separate", **SEP_KW),
        torch.Generator(device=dev).manual_seed(0)))
    tr.rollout._graphs = False
    w = ppo_launches(tr.actor_cfg, tr.rl, model_reward=True,
                     critic_cfg=tr.critic_cfg)
    _run_ppo(tr, prompts[0], g, w, "remat full warm", 7)
    secs, _, _, recs = _run_ppo(tr, prompts[1], g, w, "remat full", 7)
    remat = {"full": {"ms": secs * 1e3, "peak_allocated": max(
        r["peak_bytes"] for r in recs)}, "none": {
        "ms": runs["after_inference"]["ms"], "peak_allocated": max(
            r["peak_bytes"] for r in runs["after_inference"]["records"])}}
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[smoke] remat full: {remat['full']['ms']:.1f} ms, peak allocated "
        f"{remat['full']['peak_allocated'] / MIB:.1f} MiB; none "
        f"{remat['none']['ms']:.1f} ms, "
        f"{remat['none']['peak_allocated'] / MIB:.1f} MiB")
    out["remat"] = remat

    # (c) the simulator on the port's own traces at this shape
    t0 = time.perf_counter()
    phases, per = build_rlhf_phases(actor_cfg, critic_cfg, batch=SBATCH,
                                    prompt_len=SPROMPT, gen_len=SGEN,
                                    naive_generation=False)
    ck_phases, ck_per = build_rlhf_phases(
        actor_cfg, critic_cfg, batch=SBATCH, prompt_len=SPROMPT,
        gen_len=SGEN, naive_generation=False, grad_ckpt=True)
    out["trace_seconds"] = time.perf_counter() - t0
    sims = {p: run_iteration(phases, per, MemoryStrategy("None"), p, ndp=1,
                             trainable_fraction=1.0, capacity=capacity)
            for p in POLICIES}
    trace_peak = _trace_peaks(phases)
    sim_state = sum(nb for v in per.buffers.values() for nb, _ in v)
    log(f"[smoke] memory study: state {state} bytes on the card, "
        f"{sim_state} simulated; capacity {capacity}; traces built on meta "
        f"in {out['trace_seconds']:.1f} s")
    study = {}
    for policy in POLICIES:
        run = runs[policy]
        sim_rows = _sim_rows(sims[policy], RUNTIME_RLHF_PHASE_SEQUENCE)
        _print_study(f"memory study, policy {policy}", run, sim_rows,
                     trace_peak, state, log)
        rows, whole = run["replay"]
        log(f"[smoke]   stream: {run['n_events']} events from "
            f"{run['seeds']} live blocks, streams {whole['streams']}; live "
            f"requested bytes equal requested_bytes.all.current at all "
            f"{len(rows)} boundaries. Peak reserved MiB: card "
            f"{whole['card_peak_reserved'] / MIB:.1f} (fragmentation then "
            f"{whole['card_frag_at_peak'] / MIB:.1f}), replay "
            f"{whole['replay_peak_reserved'] / MIB:.1f} "
            f"({whole['replay_frag_at_peak'] / MIB:.1f}), simulator "
            f"{sims[policy].peak_reserved / MIB:.1f} "
            f"({sims[policy].frag_at_peak / MIB:.1f}); cudaMallocs card "
            f"{sum(r['card_mallocs'] for r in rows)}, replay "
            f"{whole['replay_mallocs']}")
        study[policy] = {"ms": run["ms"], "records": run["records"],
                         "steady": run["steady"],
                         "replay_rows": rows, "replay": whole,
                         "sim_rows": sim_rows,
                         "sim": {k: getattr(sims[policy], k) for k in (
                             "peak_reserved", "peak_allocated",
                             "frag_at_peak", "n_cuda_malloc", "time_s")}}
    out["study"] = study
    out["trace_peak"] = trace_peak
    by_tag, by_op = phases[6].trace.live_at_peak()
    out["train_actor_peak"] = {"by_tag": by_tag, "by_op": by_op,
                               "inputs": phases[6].trace.inputs}
    log("[smoke] train_actor's trace at its peak, MiB by tag: " + ", ".join(
        f"{k} {v / MIB:.1f}" for k, v in sorted(by_tag.items())) +
        "; inputs (persistent) " + ", ".join(
        f"{k} {v / MIB:.1f}" for k, v in sorted(
            phases[6].trace.inputs.items())) + "; by op: " + ", ".join(
        f"{k} {v / MIB:.1f}" for k, v in sorted(
            by_op.items(), key=lambda kv: -kv[1])[:8]))
    eager = study["after_inference"]["records"]
    graphed = sep["iterations"][-1]["phases"]
    if actor_cfg.num_layers != get_config(SEP_ACTOR).num_layers:
        graphed = []        # phase 8 ran the pair at full depth
        log(f"[smoke] (phase 8's graphed iteration ran "
            f"{get_config(SEP_ACTOR).num_layers} layers, this study "
            f"{actor_cfg.num_layers}: not printed beside it)")
    else:
        log("[smoke] phase 8's graphed iteration beside this eager one "
            "(after_inference), MiB above the state: live / reserved / "
            "peak")
    for rec, row in zip(eager, graphed):
        log(f"  {rec['phase']:15s} eager {(rec['live_bytes'] - state) / MIB:9.1f}"
            f" {(rec['reserved_bytes'] - state) / MIB:9.1f} "
            f"{(rec['peak_bytes'] - state) / MIB:9.1f} | graphed "
            f"{row['live_mib']:9.1f} {row['reserved_mib']:9.1f} "
            f"{row['peak_mib']:9.1f}")

    # (d) the simulated offload state against phase 9's measured, per
    # boundary: on the card (the state less the parked) and on the host
    # run_iteration leaves out leaves under 4096 bytes: opt_350m's biases
    # and norm scales, under 0.5 MiB
    dropped = sum(nb for v in per.buffers.values() for nb, _ in v
                  if nb < 4096)
    offload = {}
    for level in OFFLOAD_LEVELS:
        run9 = off["separate"][level]
        sim = run_iteration(phases, per, MemoryStrategy("None", offload=level),
                            run9["policy"], ndp=1, trainable_fraction=1.0,
                            capacity=capacity)
        rows = []
        for rec, s in zip(run9["records"], _sim_rows(
                sim, RUNTIME_RLHF_PHASE_SEQUENCE)):
            card = run9["state_bytes"] - rec["host_bytes"]
            rows.append({"phase": rec["phase"], "card_state": card,
                         "sim_state": s["state_bytes_end"],
                         "card_host": rec["host_bytes"],
                         "sim_host": s["host_bytes"]})
            if abs(card - s["state_bytes_end"]) >= MIB or \
                    abs(rec["host_bytes"] - s["host_bytes"]) >= MIB:
                raise SystemExit(f"offload {level} {rec['phase']}: card "
                                 f"state {card} host {rec['host_bytes']}, "
                                 f"simulated {s['state_bytes_end']} "
                                 f"{s['host_bytes']}")
        offload[level] = rows
        log(f"[smoke] offload {level}: simulated state on the card / host "
            f"GB per boundary equal phase 9's to the MiB: " + ", ".join(
                f"{r['phase']} {r['sim_state'] / 1e9:.3f}/"
                f"{r['sim_host'] / 1e9:.3f}" for r in rows))
    out["offload"] = offload

    # (e) R1-R3 on the card beside the simulator
    def frag(r):
        return r["card_frag_at_peak"] / (r["card_peak_reserved"]
                                         - r["card_frag_at_peak"])
    none, ai, aa = (study[p] for p in ("none", "after_inference",
                                       "after_all"))
    sim_none, sim_ai, sim_aa = (sims[p] for p in ("none", "after_inference",
                                                  "after_all"))
    ck = run_iteration(ck_phases, ck_per, MemoryStrategy("None"),
                       "after_inference", ndp=1, trainable_fraction=1.0,
                       capacity=capacity)
    roles_sim = run_iteration(phases, per, MemoryStrategy(
        "None", offload="roles"), "after_inference", ndp=1,
        trainable_fraction=1.0, capacity=capacity)
    res9 = {k: max(r["reserved_bytes"] for r in off["separate"][k]["records"])
            for k in ("none", "roles")}
    claims = {
        "R1_frag_over_used": {
            "card": frag(none["replay"]),
            "replay": none["replay"]["replay_frag_at_peak"] / (
                none["replay"]["replay_peak_reserved"]
                - none["replay"]["replay_frag_at_peak"]),
            "sim": sim_none.frag_at_peak / (sim_none.peak_reserved
                                            - sim_none.frag_at_peak)},
        "R3_reserved_cut_after_inference": {
            "card": 1 - ai["replay"]["card_peak_reserved"]
            / none["replay"]["card_peak_reserved"],
            "sim": 1 - sim_ai.peak_reserved / sim_none.peak_reserved},
        "R3_steady_reserved_cut_after_inference": {
            "card": 1 - max(r["reserved_bytes"] for r in ai["steady"])
            / max(r["reserved_bytes"] for r in none["steady"])},
        "R3_time_overhead_after_inference": {
            "card": ai["ms"] / none["ms"] - 1,
            "sim": sim_ai.time_s / sim_none.time_s - 1},
        "R3_after_all_vs_after_inference_reserved": {
            "card": aa["replay"]["card_peak_reserved"]
            / ai["replay"]["card_peak_reserved"] - 1,
            "sim": sim_aa.peak_reserved / sim_ai.peak_reserved - 1},
        "R3_after_all_vs_after_inference_time": {
            "card": aa["ms"] / ai["ms"] - 1,
            "sim": sim_aa.time_s / sim_ai.time_s - 1},
        "R2_remat_cut_peak_allocated": {
            "card": 1 - remat["full"]["peak_allocated"]
            / remat["none"]["peak_allocated"],
            "sim": 1 - ck.peak_allocated / sim_ai.peak_allocated},
        "R2_roles_cut_peak_reserved": {
            "card": 1 - res9["roles"] / res9["none"],
            "sim": 1 - roles_sim.peak_reserved / sim_ai.peak_reserved}}
    out["claims"] = claims
    out["dropped_small_leaves"] = dropped
    log("[smoke] R1-R3 on the card (card / simulator on the port's traces; "
        "R1 also the replay of the card's stream; R2's roles cut from "
        "phase 9's boundary records, graphed; R1's naive-cache mechanism "
        "stays a simulator result, the runtime has a fixed cache):")
    for k, v in claims.items():
        log(f"  {k:42s} " + ", ".join(f"{n} {x:+.4f}" for n, x in v.items()))
    out["grpo"] = grpo_on_card(dev, capacity, log)
    return out


# ---------------------------------------------------------------- phase 12
# the flight recorder's watermark: below the boundary live share of phase
# 8's pair (19.2 of 79.2 GiB), so the first boundary trips it
WATERMARK = 0.2
# the OOM cap: between the rollout's reserved (~20.3 GiB) and train_actor's
# (~32.6 GiB) on the 79.2 GiB card
OOM_FRACTION = 0.31
STATE_OWNERS = ("ref_params", "reward_params", "actor_params", "actor_opt",
                "critic_params", "critic_opt")


def _checked_records(tr, dev, seen):
    """Wrap ``tr.memory._record`` so that each record's owner table plus
    residue, its live bytes and ``memory_allocated`` read just after it go
    into ``seen``."""
    record = tr.memory._record

    def checked(*a, **k):
        rec = record(*a, **k)
        seen.append((sum(rec["attrib"].values()) + rec["attrib_unattributed"],
                     rec["live_bytes"], torch.cuda.memory_allocated(dev),
                     dict(rec["attrib"]), rec["phase"]))
        return rec
    tr.memory._record = checked


def _print_telemetry(spans, log):
    log("[smoke] telemetry phase spans (MiB): measured / simulated live, "
        "delta | measured / simulated peak, delta | unattributed")
    for s in spans:
        a = s.args
        log(f"  {s.name:15s} {a['measured_bytes'] / MIB:9.1f} "
            f"{a['sim_bytes'] / MIB:9.1f} {a['sim_delta_bytes'] / MIB:+8.1f} "
            f"| {a['measured_peak_bytes'] / MIB:9.1f} "
            f"{a['sim_peak_bytes'] / MIB:9.1f} "
            f"{(a['measured_peak_bytes'] - a['sim_peak_bytes']) / MIB:+8.1f} "
            f"| {a['attrib_unattributed'] / MIB:8.1f}")


def telemetry_ppo(dev, log, plain=None, profile=False):
    """Phase 12: runtime telemetry on the card (``repro_torch.obs``) on
    phase 8's OPT pair and shape, graphed decode, the reward model
    scoring. (a) Two iterations with ``RunTelemetry.create(sim_delta=True,
    annotate=True)``, the trainer's attributor and a flight recorder at
    watermark 0.2, launches asserted (``ppo_launches``): 7 phase spans an
    iteration in order, tiling it; at every record the owner table plus
    residue equal to the measured bytes and to ``memory_allocated``; the
    six state owners each their trees' ``nbytes`` within the allocator's
    512-byte rounding, together the persistent state; the simulator's
    bytes on every span; the watermark dump with owners, top buffers and
    phase history; metrics equal to ``plain`` (phase 8's iterations of the
    same seeds, or two run here) to the bit; the tracer's self-time at
    most 2% of the second iteration's wall; the per-record and the full
    (block) walk timed; the JSONL rendered by ``launch.report``; the
    JSONL, Chrome trace and dumps written under ``chiprun_out/``. (b) A
    fresh trainer capped at ``OOM_FRACTION`` of the card: ``train_step``
    must raise ``torch.cuda.OutOfMemoryError`` in train_actor, dumped
    with its owners and top buffers. With ``profile``, one more iteration
    under ``torch.profiler`` must hold every phase name as a user
    annotation."""
    from repro_torch.launch import report as RP
    from repro_torch.obs import FlightRecorder, RunTelemetry
    actor_cfg, critic_cfg = get_config(SEP_ACTOR), get_config(SEP_CRITIC)
    rl = RLHFConfig(engine="separate", memory_policy="after_inference",
                    **SEP_KW)
    want = ppo_launches(actor_cfg, rl, model_reward=True,
                        critic_cfg=critic_cfg)
    prompts = [_sep_prompts(dev, 1 + it, actor_cfg.vocab_size)
               for it in range(SITERS)]
    out = {}
    if plain is None:
        tr, _, _ = _separate_trainer(dev, "after_inference")
        g = torch.Generator(device=dev).manual_seed(7)
        plain = [_run_ppo(tr, p, g, want, "plain", 7)[1] for p in prompts]
        del tr
        gc.collect()
        torch.cuda.empty_cache()

    # (a) two iterations with telemetry
    fl = FlightRecorder(watermark=WATERMARK, ring=256,
                        path=str(OUT_DIR / "flight_watermark.json"))
    tel = RunTelemetry.create(sim_delta=True, annotate=True, flight=fl,
                              engine="separate", actor=SEP_ACTOR,
                              critic=SEP_CRITIC, batch=SBATCH,
                              prompt_len=SPROMPT, gen_len=SGEN)
    tr, state, _ = _fresh(lambda: RLHFTrainer(
        actor_cfg, critic_cfg, rl, torch.Generator(device=dev).manual_seed(0),
        telemetry=tel))
    trees = tr.persistent_trees()
    seen = []
    _checked_records(tr, dev, seen)
    g = torch.Generator(device=dev).manual_seed(7)
    iters = []
    for it, p in enumerate(prompts):
        self0 = tel.tracer.self_time_s
        secs, m, launches, _ = _run_ppo(tr, p, g, want,
                                        f"telemetry iteration {it}", 7)
        iters.append({"seconds": secs, "metrics": m,
                      "self_time_s": tel.tracer.self_time_s - self0})
        if m != plain[it]:
            raise SystemExit(f"telemetry iteration {it}: metrics {m} != "
                             f"{plain[it]} without telemetry")
    t0 = time.perf_counter()
    quick = tel.attribution.snapshot()
    t1 = time.perf_counter()
    full = tel.attribution.snapshot(full=True)
    t2 = time.perf_counter()
    walks = {"plain_ms": (t1 - t0) * 1e3, "full_ms": (t2 - t1) * 1e3,
             "n_owner_storages": quick.n_arrays, "n_blocks": full.n_arrays,
             "owners_plain": quick.owners, "owners_full": full.owners}
    log(f"[smoke] telemetry walks: per record {walks['plain_ms']:.2f} ms over "
        f"{quick.n_arrays} owner storages, full (allocator blocks) "
        f"{walks['full_ms']:.2f} ms over {full.n_arrays} blocks; owners "
        f"plain and full differ by " + ", ".join(
            f"{k} {full.owners[k] - v:+d}" for k, v in quick.owners.items()
            if full.owners[k] != v))
    overhead = iters[-1]["self_time_s"] / iters[-1]["seconds"]
    log(f"[smoke] telemetry iterations: " + ", ".join(
        f"{r['seconds'] * 1e3:.1f} ms (self {r['self_time_s'] * 1e3:.2f} ms)"
        for r in iters) + f"; overhead {overhead:.4%} of the second; "
        f"metrics equal to the run without telemetry to the bit")
    if overhead > 0.02:
        raise SystemExit(f"telemetry overhead {overhead:.4f} > 0.02")

    # every record: exact, and the allocator's own figure
    bad = [s for s in seen if not s[0] == s[1] == s[2]]
    if len(seen) != 7 * SITERS or bad:
        raise SystemExit(f"telemetry records: {len(seen)} records, not exact "
                         f"at {[(s[4], s[:3]) for s in bad]}")
    rounding = {n: 512 * sum(1 for _ in leaves(trees[n])) for n in trees}
    for *_, attrib, phase in seen:
        for n in STATE_OWNERS:
            nb = tree_nbytes(trees[n])
            if not nb <= attrib.get(n, 0) <= nb + rounding[n]:
                raise SystemExit(f"telemetry {phase}: owner {n} "
                                 f"{attrib.get(n, 0)} for a tree of {nb}")
        if sum(attrib.get(n, 0) for n in STATE_OWNERS) < tree_nbytes(trees):
            raise SystemExit(f"telemetry {phase}: state owners below the "
                             f"state's {tree_nbytes(trees)} bytes")
    spans = [s for s in tel.tracer.spans if s.cat == "phase"]
    its = [s for s in tel.tracer.spans if s.cat == "iteration"]
    n = len(RUNTIME_RLHF_PHASE_SEQUENCE)
    if [s.name for s in spans] != list(RUNTIME_RLHF_PHASE_SEQUENCE) * SITERS \
            or len(its) != SITERS:
        raise SystemExit(f"telemetry spans {[s.name for s in spans]}")
    for i, it in enumerate(its):
        mine = spans[i * n:(i + 1) * n]
        ends = [s.ts_us + s.dur_us for s in mine]
        if mine[0].ts_us != it.ts_us or any(
                b.ts_us != e for b, e in zip(mine[1:], ends)) or \
                ends[-1] > it.ts_us + it.dur_us:
            raise SystemExit(f"telemetry iteration {i}: phases do not tile")
    for s in spans:
        if not {"sim_bytes", "sim_peak_bytes", "sim_delta_bytes"} <= set(
                s.args):
            raise SystemExit(f"telemetry {s.name}: no simulator prediction")
    _print_telemetry(spans[-n:], log)
    last = spans[-n:]
    log("[smoke] owners at each boundary of the second iteration (MiB):")
    for owner in sorted({k for s in last for k in s.args["attrib"]}):
        log(f"  {owner:16s} " + " ".join(
            f"{s.args['attrib'].get(owner, 0) / MIB:9.1f}" for s in last))
    log(f"  {'(unattributed)':16s} " + " ".join(
        f"{s.args['attrib_unattributed'] / MIB:9.1f}" for s in last))
    if not fl.dumps:
        raise SystemExit("telemetry: the watermark never tripped")
    dump = fl.dumps[0]
    if not (dump["trigger"] == "watermark" and dump["owners_ranked"]
            and dump["top_buffers"] and dump["phase_history"]):
        raise SystemExit(f"telemetry watermark dump: {dump}")
    log(RP.flight_summary(dump))
    jsonl = tel.write_jsonl(str(OUT_DIR / "telemetry.jsonl"))
    tel.write_chrome_trace(str(OUT_DIR / "telemetry_trace.json"))
    rendered = RP.render(jsonl, show_metrics=True)
    (OUT_DIR / "telemetry_report.txt").write_text(rendered)
    log(RP.phase_table(RP.load(jsonl)[1]))
    out.update(iterations=iters, overhead=overhead, walks=walks,
               launches=launches, state_bytes=state,
               spans=[{"name": s.name, **{k: v for k, v in s.args.items()
                                          if k != "sim_owner_bytes"}}
                      for s in last],
               watermark_dump={k: dump[k] for k in (
                   "phase", "live_bytes", "capacity_bytes", "owners",
                   "unattributed", "top_buffers")},
               sim_phase_bytes=tr.memory.sim_phase_bytes)
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        torch.cuda.synchronize()
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            tr.train_step(prompts[0], g)
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()}
        missing = [p for p in RUNTIME_RLHF_PHASE_SEQUENCE + ("ppo_iteration",)
                   if p not in names]
        if missing:
            raise SystemExit(f"telemetry: no profiler annotation {missing}")
        log("[smoke] telemetry under torch.profiler: every phase span is a "
            "user annotation")
    # the attributor's getters hold the trainer: drop the bundle with it
    del tr, trees, quick, full, tel
    gc.collect()
    torch.cuda.empty_cache()
    out["oom"] = caught_oom(dev, log, rl, prompts[0])
    return out


def caught_oom(dev, log, rl, prompts):
    """Phase 12 (b): a fresh trainer of phase 8's pair with telemetry, the
    process capped at ``OOM_FRACTION`` of the card: ``train_step`` must
    raise ``torch.cuda.OutOfMemoryError``, and the flight recorder hold one
    dump of it, in train_actor, with the CUDA message, owners and top
    buffers; the cap is lifted and the trainer dropped after."""
    from repro_torch.launch import report as RP
    from repro_torch.obs import FlightRecorder, RunTelemetry
    fl = FlightRecorder(path=str(OUT_DIR / "flight_oom.json"))
    tel = RunTelemetry.create(sim_delta=False, flight=fl)
    tr, _, _ = _fresh(lambda: RLHFTrainer(
        get_config(SEP_ACTOR), get_config(SEP_CRITIC), rl,
        torch.Generator(device=dev).manual_seed(0), telemetry=tel))
    cap = int(OOM_FRACTION * torch.cuda.mem_get_info()[1])
    card = torch.cuda.current_device()
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(OOM_FRACTION, card)
    msg = None
    try:
        tr.train_step(prompts, torch.Generator(device=dev).manual_seed(7))
    except torch.cuda.OutOfMemoryError as e:
        msg = str(e)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, card)
    del tr, tel
    gc.collect()
    torch.cuda.empty_cache()
    if msg is None:
        raise SystemExit(f"telemetry: no OutOfMemoryError under a cap of "
                         f"{cap} bytes")
    (oom,) = fl.dumps
    if not (oom["trigger"] == "resource_exhausted"
            and oom["error"] == f"OutOfMemoryError: {msg}"[:2000]
            and oom["phase"] == "train_actor" and oom["owners"]
            and oom["top_buffers"]):
        raise SystemExit(f"telemetry OOM dump: {oom}")
    log(f"[smoke] OOM under a cap of {cap / MIB:.0f} MiB: raised and "
        f"re-raised, dumped in {oom['phase']}")
    log(RP.flight_summary(oom))
    out = {k: oom[k] for k in ("phase", "error", "live_bytes", "owners",
                               "unattributed", "top_buffers")}
    out["cap_bytes"] = cap
    return out


# ---------------------------------------------------------------- phase 13
# the verify's logits are held against an fp32 forward of the same tokens
# (the weights cast to fp32, the full-sequence path), as vanilla's
# decode-step logits are against one of vanilla's tokens: per query the RMS
# error over the vocabulary, and the verify's largest must be within
# SPEC_ERR_RATIO of vanilla's largest. Both bf16 paths stand ~0.05 RMS off
# the fp32 function, and each flips ~10% of its argmaxes against it where
# random init makes near-ties: so a row may leave vanilla greedy's tokens
# without either being wrong. Each call also plants an off-by-one position
# mask in the verify's attention, both ways (SPEC_FAULTS), and the check
# must refuse each (the card's readings: PERF.md §6, PR 25).
SPEC_ERR_RATIO = 2.0
SPEC_FAULTS = ("drops_own_position", "sees_next_position")
# the reference's decode bench (benchmarks/run.py:413-535): its tiny llama
# at mtp_depth 3 trained 300 steps on t_{i+1} = (t_i + 1) mod 64, then
# 4 x (8 + 64) greedy
CYC_V, CYC_K, CYC_STEPS, CYC_S, CYC_TB = 64, 3, 300, 32, 8
CYC_B, CYC_P, CYC_G = 4, 8, 64


def _spec_call(ro, params, prompts, n, dev):
    """One generate call of ``n`` new tokens: its tokens and log-probs on
    the host, synchronised seconds, launches from 0, peak allocated bytes
    and the call's decode, spec and page-manager records."""
    gc.collect()
    torch.cuda.synchronize()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = ro.generate(params, {"tokens": prompts}, n,
                      torch.Generator(device=dev))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = {"bits": (res.tokens.cpu(), res.logp.cpu()), "s": secs,
           "launches": dict(ops.launches),
           "peak": torch.cuda.max_memory_allocated(),
           "decode": dict(ro.decode_stats),
           "spec": dict(ro.spec_stats) if ro.spec_decode and n > 1 else None}
    pm = ro.page_manager
    if ro.backend == "paged":
        pm.check_invariants()
        if pm.stats.pages_in_use:
            raise SystemExit(f"{pm.stats.pages_in_use} pages in use after "
                             "the call")
        out["pages"] = {"peak_pages_in_use": pm.stats.peak_pages_in_use,
                        "n_page_alloc": pm.stats.n_page_alloc}
    del res
    return out


def _greedy_logits(ro, params, prompts, n, dev):
    """A vanilla greedy call with each step's logits kept (``sample_token``
    wrapped in this script): (call, logits [B, n, V] on the card, as the
    step made them)."""
    from repro_torch.rlhf import rollout as RO
    plain, kept = RO.sample_token, []

    def recording(generator, logits, **kw):
        kept.append(logits.clone())
        return plain(generator, logits, **kw)

    RO.sample_token = recording
    try:
        call = _spec_call(ro, params, prompts, n, dev)
    finally:
        RO.sample_token = plain
    return call, torch.stack(kept, 1)


def _verify_logits(model, backend, run):
    """``run()`` (an eager spec call) with each verify forward's tokens,
    positions and logits kept (the instance's ``decode_multi`` or
    ``paged_decode_multi`` wrapped in this script) -> (its result,
    [(tokens [B,T], positions [B,T], logits [B,T,V])])."""
    name = "paged_decode_multi" if backend == "paged" else "decode_multi"
    plain, kept = getattr(model, name), []

    def keep(params, state, tokens, positions, *rest):
        out = plain(params, state, tokens, positions, *rest)
        kept.append((tokens.clone(), positions.clone(), out[0].clone()))
        return out

    setattr(model, name, keep)
    try:
        return run(), kept
    finally:
        delattr(model, name)


def _fp32_logits(model, p32, tokens, start):
    """Logits [B, S - start, V] of the fp32 full-sequence forward
    (``p32``: the weights cast to fp32) over ``tokens`` [B, S] on the
    card, a row at a time, from position ``start`` on."""
    out = []
    with torch.no_grad():
        for b in range(tokens.shape[0]):
            lg = model.forward(p32, {"tokens": tokens[b:b + 1]})[0]
            out.append(lg[0, start:].clone())
            del lg
    return torch.stack(out)


def _query_error(got, want):
    """(largest per-query RMS over the vocabulary of ``got - want``,
    argmax flips, queries) for logits [Q, V]."""
    rms = (got.float() - want).pow(2).mean(-1).sqrt()
    flips = int((got.float().argmax(-1) != want.argmax(-1)).sum())
    return float(rms.max()), flips, rms.numel()


def _verify_error(model, p32, tokens, kept, prompt):
    """Every kept verify query whose context is the run's own tokens
    (``tokens`` [B, S] up to the query's position: each step's first
    query, and a draft's when the drafts up to it were accepted) against
    the fp32 forward of ``tokens`` -> ``_query_error``."""
    ref = _fp32_logits(model, p32, tokens, prompt)
    own, S = tokens.cpu(), tokens.shape[1]
    got, want = [], []
    for tk, pos, lg in kept:
        tk, pos = tk.cpu(), pos.cpu()
        for b, j in ((b, j) for b in range(tk.shape[0])
                     for j in range(tk.shape[1])):
            p = int(pos[b, j])
            if prompt <= p < S and torch.equal(tk[b, :j + 1],
                                               own[b, p - j:p + 1]):
                got.append(lg[b, j])
                want.append(ref[b, p - prompt])
    del ref
    return _query_error(torch.stack(got), torch.stack(want))


def _plant(fault):
    """Swap ``layers.sdpa``, which the verify's attention alone calls
    (dense and paged), for one whose mask is off by one position: each
    query loses its own position, or sees the next one (the next draft).
    -> the function to put back."""
    plain = LAYERS.sdpa

    def planted(q, k, v, mask):
        shift = -1 if fault == "drops_own_position" else 1
        moved = torch.roll(mask, shift, -1)
        return plain(q, k, v, mask & moved if shift < 0 else mask | moved)

    LAYERS.sdpa = planted
    return plain


def _verify_check(model, params, prompts, spec, backend, van, van_logits,
                  eager, kept, dev):
    """Phase 13 (a)'s check of the verify's logits (see SPEC_ERR_RATIO)
    on the eager spec call ``eager`` (its verify forwards ``kept``) and
    the vanilla greedy call ``van`` (its step logits ``van_logits``); then
    the same for each planted fault, which must fail it. Also each row's
    first divergence from vanilla's tokens, with the fp32 logit of
    vanilla's token there less the spec run's."""
    p32 = tree_map(lambda t: t.float(), params)
    van_tokens = van["bits"][0].to(dev)
    ref = _fp32_logits(model, p32, van_tokens, PROMPT - 1)
    n = van_logits.shape[1]
    # step i's logits score token PROMPT + i; step 0's are the prefill's
    dec = _query_error(van_logits[:, 1:].flatten(0, 1),
                       ref[:, 1:n].flatten(0, 1))
    spec_tokens = eager["bits"][0]
    rows = []
    for b in range(van_tokens.shape[0]):
        d = (spec_tokens[b, PROMPT:] != van_tokens[b, PROMPT:].cpu()) \
            .nonzero()
        if len(d):
            i = int(d[0])
            w = int(van_tokens[b, PROMPT + i])
            g = int(spec_tokens[b, PROMPT + i])
            rows.append({"row": b, "index": i,
                         "fp32_gap": float(ref[b, i, w] - ref[b, i, g])})
    del ref
    ver = _verify_error(model, p32, spec_tokens.to(dev), kept, PROMPT)
    out = {"verify_rms": ver[0], "verify_flips": ver[1],
           "verify_queries": ver[2], "vanilla_rms": dec[0],
           "vanilla_flips": dec[1], "vanilla_queries": dec[2],
           "ratio": ver[0] / dec[0], "diverged": rows, "faults": {}}
    for fault in SPEC_FAULTS:
        plain = _plant(fault)
        try:
            c, kept_f = _verify_logits(model, backend, lambda: _spec_call(
                spec, params, prompts, GEN, dev))
        finally:
            LAYERS.sdpa = plain
        e = _verify_error(model, p32, c["bits"][0].to(dev), kept_f, PROMPT)
        out["faults"][fault] = {"rms": e[0], "flips": e[1], "queries": e[2],
                                "ratio": e[0] / dec[0]}
        del c, kept_f
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _spec_backend(model, cfg, params, prompts, backend, weights, dev, log):
    """Phase 13 (a) and (b) on one backend: vanilla greedy (its logits
    kept), the spec rollout eager (its verify logits kept) and graphed
    (the same bits), graphed with the forced drafter; then, timed in
    turns, the prefill calls, vanilla, spec, forced, spec, vanilla."""
    kw = dict(capacity=PROMPT + GEN, temperature=0.0, top_k=0,
              backend=backend, page_size=PAGE)
    van = Rollout(model, cfg, **kw)
    spec = Rollout(model, cfg, spec_decode=True, spec_k=SPEC_K, **kw)
    label = f"spec {backend} llama3_2_3b"
    van_first, van_logits = _greedy_logits(van, params, prompts, GEN, dev)
    spec._graphs = False
    eager, kept = _verify_logits(model, backend, lambda: _spec_call(
        spec, params, prompts, GEN, dev))
    check = _verify_check(model, params, prompts, spec, backend, van_first,
                          van_logits, eager, kept, dev)
    del van_logits, kept
    spec._graphs = True
    graphed = _spec_call(spec, params, prompts, GEN, dev)
    # the spec run's own continuation: vanilla's parts from it at a
    # near-tie, after which vanilla's tokens would be refused for good
    cont = eager["bits"][0][:, PROMPT:].to(dev)

    def forced_call():
        model.mtp_draft = forced_drafts(model, cont, SPEC_K)
        try:
            return _spec_call(spec, params, prompts, GEN, dev)
        finally:
            del model.mtp_draft

    van_pre = _spec_call(van, params, prompts, 1, dev)
    spec_pre = _spec_call(spec, params, prompts, 1, dev)
    van_a = _spec_call(van, params, prompts, GEN, dev)
    graphed_b = _spec_call(spec, params, prompts, GEN, dev)
    forced = forced_call()
    forced_b = forced_call()
    van_b = _spec_call(van, params, prompts, GEN, dev)
    for c in (van_a, van_b):
        if not _same_bits(c["bits"], van_first["bits"]):
            raise SystemExit(f"{label}: vanilla greedy differs call to call")
    for c in (graphed, graphed_b):
        if not _same_bits(c["bits"], eager["bits"]):
            raise SystemExit(f"{label}: the graphed spec step's tokens or "
                             "log-probs differ from the eager step's")
    if not _same_bits(forced["bits"], forced_b["bits"]):
        raise SystemExit(f"{label}: forced runs differ call to call")
    # the drafts never change the output: accepted or refused, every token
    # is the verify's own argmax of the same context
    if not torch.equal(forced["bits"][0], eager["bits"][0]):
        raise SystemExit(f"{label}: the forced drafts changed the tokens")
    forced_lp_err = float((forced["bits"][1] - eager["bits"][1]).abs().max())
    if not (graphed["decode"]["graphed"] and not eager["decode"]["graphed"]
            and graphed["decode"]["replays"] == graphed["spec"]["steps"] - 1):
        raise SystemExit(f"{label}: not graphed as asked: "
                         f"{graphed['decode']} / {eager['decode']}")
    for name, c in (("graphed", graphed), ("eager", eager),
                    ("forced", forced)):
        want = spec_launches(cfg, c["spec"]["steps"], SPEC_K)
        if c["launches"] != want:
            raise SystemExit(f"{label} {name}: launches {c['launches']} != "
                             f"{want}")
    L = cfg.num_layers
    kern = "paged_decode_attention" if backend == "paged" \
        else "decode_attention"
    if van_a["launches"][kern] != L * (GEN - 1):
        raise SystemExit(f"{label}: vanilla {kern} {van_a['launches']}")
    van_s = (van_a["s"] + van_b["s"]) / 2
    van_cap = (van_a["decode"]["capture_ms"]
               + van_b["decode"]["capture_ms"]) / 2e3
    van_step = (van_s - van_pre["s"] - van_cap) * 1e3 / (GEN - 1)
    out = {"backend": backend, "vanilla_step_ms": van_step,
           "vanilla_call_ms": [van_a["s"] * 1e3, van_b["s"] * 1e3],
           "vanilla_prefill_call_ms": van_pre["s"] * 1e3,
           "vanilla_peak_mib": (van_a["peak"] - weights) / 2**20,
           "spec_prefill_call_ms": spec_pre["s"] * 1e3,
           "launches": graphed["launches"],
           "vanilla_launches": van_a["launches"],
           "graphed_equals_eager": True, "verify_check": check,
           "forced_logp_err": forced_lp_err}
    for name, cs_ in (("random", (graphed, graphed_b)),
                      ("forced", (forced, forced_b))):
        c = cs_[1]
        st = c["spec"]
        cap = (c["decode"]["capture_ms"] or 0.0) / 1e3
        loop = (c["s"] - spec_pre["s"] - cap) * 1e3
        acc = st["accepted"] / max(st["drafted"], 1)
        out[name] = {"call_ms": [x["s"] * 1e3 for x in cs_],
                     "capture_ms": cap * 1e3,
                     "steps": st["steps"], "accept_rate": acc,
                     "verify_step_ms": loop / st["steps"],
                     "ms_per_token": loop / (GEN - 1),
                     "speedup_vs_vanilla": van_step / (loop / (GEN - 1)),
                     "peak_mib": (c["peak"] - weights) / 2**20,
                     "pages": c.get("pages")}
        o = out[name]
        log(f"[smoke] {label} ({name} heads): {st['steps']} verify steps, "
            f"accept {acc:.3f}; {o['verify_step_ms']:.3f} ms a verify "
            f"step, {o['ms_per_token']:.3f} ms an emitted token against "
            f"vanilla's {van_step:.3f} ms a step "
            f"({o['speedup_vs_vanilla']:.2f}x); capture "
            f"{o['capture_ms']:.1f} ms; peak {o['peak_mib']:.1f} MiB above "
            f"the weights (vanilla {out['vanilla_peak_mib']:.1f})"
            + ("" if name == "random" else f"; tokens the random heads' "
               f"run's, logp within {forced_lp_err:.1e}"))
    log(f"[smoke] {label}: graphed spec = eager spec bits; launches "
        f"{graphed['launches']} (B3/B4 0)"
        + (f"; pages {graphed['pages']}, 0 in use after" if backend ==
           "paged" else ""))
    f = check["faults"]
    log(f"[smoke] {label}: against an fp32 forward of the same tokens, "
        f"the verify's largest per-query logit RMS {check['verify_rms']:.4f}"
        f" ({check['verify_queries']} queries, {check['verify_flips']} "
        f"argmax flips), vanilla's decode steps' "
        f"{check['vanilla_rms']:.4f} ({check['vanilla_queries']}, "
        f"{check['vanilla_flips']} flips): {check['ratio']:.3f}x (limit "
        f"{SPEC_ERR_RATIO}); planted faults "
        + ", ".join(f"{k} {v['rms']:.4f} ({v['ratio']:.2f}x, {v['flips']} "
                    f"flips)" for k, v in f.items())
        + f"; rows leaving vanilla greedy {len(check['diverged'])} of "
        f"{prompts.shape[0]}: "
        + ", ".join(f"row {r['row']} at {r['index']} (fp32 logit of "
                    f"vanilla's token less the spec's {r['fp32_gap']:+.4f})"
                    for r in check["diverged"]))
    if not check["ratio"] <= SPEC_ERR_RATIO:
        raise SystemExit(f"{label}: the verify's logits are {check['ratio']}"
                         f"x vanilla's error against fp32 (limit "
                         f"{SPEC_ERR_RATIO})")
    blind = [k for k, v in f.items() if not v["ratio"] > SPEC_ERR_RATIO]
    if blind:
        raise SystemExit(f"{label}: the verify check passes the planted "
                         f"faults {blind}: {f}")
    return out


def _cyclic_bench(dev, log):
    """Phase 13 (c): the reference's decode bench through the port. Its
    tiny llama at mtp_depth 3, with head_dim 64 (2 heads, 1 KV head: the
    same d_model 128 and GQA ratio; the card's attention kernels take
    head_dim 64 or 128, not the reference's 32), f32, trained 300 AdamW
    steps (lr 3e-3) on the cyclic-token task with the chain at window 1;
    then 4 x (8 + 64) greedy, vanilla against spec (k 3), graphed, best
    of 7 calls each after a first: tokens bit for bit, logp within 1e-5,
    accept rate at least 0.90 (the reference's gate); the speedup is
    printed beside the reference's gate of 1.2x."""
    from repro_torch.optim import AdamW
    cfg = dataclasses.replace(
        get_config("llama3_2_3b").smoke(), num_layers=2, d_model=128,
        d_ff=256, vocab_size=CYC_V, num_heads=2, num_kv_heads=1,
        head_dim=64, mtp_depth=CYC_K)
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    for p in leaves(params):
        p.requires_grad_(True)
    opt = AdamW()
    state = opt.init(params)
    g = torch.Generator().manual_seed(0)
    ar = torch.arange(CYC_S)
    t0 = time.perf_counter()
    for _ in range(CYC_STEPS):
        start = torch.randint(0, CYC_V, (CYC_TB, 1), generator=g)
        tokens = ((start + ar[None]) % CYC_V).to(dev)
        mask = torch.ones_like(tokens)
        with torch.enable_grad():
            logits, _, h = model.forward(params, {"tokens": tokens})
            loss = TS.lm_loss(logits, tokens, mask)
            for d, lg in enumerate(model.mtp_chain_logits(
                    params, h, tokens, window=1), start=1):
                loss = loss + TS.mtp_loss(lg, tokens, mask,
                                          offset=d + 1) / CYC_K
            grads = torch.autograd.grad(loss, list(leaves(params)))
        it = iter(grads)
        opt.update_(tree_map(lambda _: next(it), params), state, params,
                    3e-3)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    final = float(loss.detach())
    for p in leaves(params):
        p.requires_grad_(False)
    prompts = ((torch.randint(0, CYC_V, (CYC_B, 1), generator=g)
                + torch.arange(CYC_P)[None]) % CYC_V).to(dev)
    runs = {}
    for name, kw in (("vanilla", {}),
                     ("spec", {"spec_decode": True, "spec_k": CYC_K})):
        ro = Rollout(model, cfg, capacity=CYC_P + CYC_G, temperature=0.0,
                     top_k=0, **kw)
        first = _spec_call(ro, params, prompts, CYC_G, dev)
        best = min(_spec_call(ro, params, prompts, CYC_G, dev)["s"]
                   for _ in range(7))
        runs[name] = (first, best, ro)
    (van, tv, _), (spec, ts, ro) = runs["vanilla"], runs["spec"]
    if not torch.equal(van["bits"][0], spec["bits"][0]):
        raise SystemExit("cyclic bench: spec tokens differ from vanilla's")
    lp_err = float((van["bits"][1] - spec["bits"][1]).abs().max())
    if not lp_err < 1e-5:
        raise SystemExit(f"cyclic bench: logp differ by {lp_err}")
    st = spec["spec"]
    accept = st["accepted"] / max(st["drafted"], 1)
    if not accept >= 0.90:
        raise SystemExit(f"cyclic bench: accept rate {accept:.3f} < 0.90")
    out = {"train_s": train_s, "final_loss": final,
           "vanilla_tok_s": CYC_B * CYC_G / tv,
           "spec_tok_s": CYC_B * CYC_G / ts, "speedup": tv / ts,
           "accept_rate": accept, "steps": st["steps"],
           "dispatch_reduction": CYC_G / st["steps"], "logp_err": lp_err,
           "vanilla_call_ms": tv * 1e3, "spec_call_ms": ts * 1e3}
    log(f"[smoke] cyclic-token bench (the reference's decode bench, head_dim"
        f" 64): {CYC_STEPS} train steps in {train_s:.1f} s, final loss "
        f"{final:.4f}; vanilla {out['vanilla_tok_s']:.0f} tok/s, spec "
        f"{out['spec_tok_s']:.0f} tok/s: speedup {out['speedup']:.2f}x "
        f"(the reference's gate 1.2x), accept {accept:.3f} (gate 0.90), "
        f"{st['steps']} verify steps ({out['dispatch_reduction']:.2f}x fewer"
        f" dispatches); tokens identical, logp within {lp_err:.1e}")
    return out


def _spec_ppo(dev, log):
    """Phase 13 (e): one hydra PPO iteration of phase 7's llama3_2_3b
    shape with 2 MTP heads and ``spec_decode`` (k 2): launches as
    reckoned (``ppo_launches`` with the rollout's verify steps), finite
    metrics with the actor's ``mtp_loss``; per-phase ms and MiB above
    the state."""
    cfg = dataclasses.replace(get_config("llama3_2_3b"),
                              mtp_depth=SPEC_DEPTH)
    rl = RLHFConfig(memory_policy="after_inference", spec_decode=True,
                    spec_k=SPEC_K, **PPO_KW)
    tr, state = _fresh(lambda: RLHFTrainer(
        cfg, cfg, rl, torch.Generator(device=dev).manual_seed(0)))[:2]
    prompts = torch.randint(0, cfg.vocab_size, (PBATCH, PPROMPT),
                            device=dev, generator=torch.Generator(
                                device=dev).manual_seed(1))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    m = tr.train_step(prompts, torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    made = dict(ops.launches)
    st = dict(tr.rollout.spec_stats)
    want = ppo_launches(cfg, rl, True, spec_steps=st["steps"])
    if made != want:
        raise SystemExit(f"spec PPO: launches {made} != {want}")
    if not all(math.isfinite(v) for v in m.values()) or \
            not m.get("mtp_loss", 0) > 0:
        raise SystemExit(f"spec PPO: metrics {m}")
    rows = _phase_rows(tr.memory.records[-8:], state)
    _print_phases(f"spec hydra PPO llama3_2_3b + {SPEC_DEPTH} MTP heads "
                  f"(k {SPEC_K}, {st['steps']} verify steps, accept "
                  f"{st['accepted'] / max(st['drafted'], 1):.3f}), "
                  f"{secs:.2f} s", rows, log)
    log(f"[smoke] spec PPO: launches {made} as reckoned; mtp_loss "
        f"{m['mtp_loss']:.4f} in the actor's loss")
    out = {"seconds": secs, "launches": made, "metrics": m, "phases": rows,
           "spec": st, "state_bytes": state}
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def spec_decoding(dev, log, profile=False):
    """Phase 13: MTP self-speculative decoding (see the module's note):
    (a, b) full-width llama3_2_3b with 2 MTP heads on both backends, (c)
    the cyclic-token bench, (d) small spec PPO card vs CPU on both
    engines, (e) a hydra spec PPO iteration at phase 7's shape. With
    ``profile``, a graphed dense spec call and a graphed vanilla call of
    the same prompts under the profiler."""
    cfg = dataclasses.replace(get_config("llama3_2_3b"),
                              mtp_depth=SPEC_DEPTH)
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()    # the weights and all else live
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    out = {"serve": {b: _spec_backend(model, cfg, params, prompts, b,
                                      weights, dev, log)
                     for b in ("dense", "paged")}}
    if profile:
        kw = dict(capacity=PROMPT + GEN, temperature=0.0, top_k=0)
        for name, ro in (("spec", Rollout(model, cfg, spec_decode=True,
                                          spec_k=SPEC_K, **kw)),
                         ("vanilla", Rollout(model, cfg, **kw))):
            prof, table = profile_call(lambda ro=ro: ro.generate(
                params, {"tokens": prompts}, GEN,
                torch.Generator(device=dev)))
            print_profile(f"{name} dense request (graphed)", prof)
            (OUT_DIR / f"profile_{name}_dense.txt").write_text(table)
            out["serve"]["dense"][f"profile_{name}"] = prof
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    out["cyclic"] = _cyclic_bench(dev, log)
    out["small_ppo"] = {}
    for engine in ("hydra", "separate"):
        r = check_small_ppo_against_cpu(dev, engine=engine, spec=True)
        log(f"[smoke] small spec {engine} PPO card vs CPU: greedy tokens "
            f"identical, metrics max_err {r['max_err']:.3e} "
            f"(tol {r['tol']:g})")
        out["small_ppo"][engine] = r
    out["ppo"] = _spec_ppo(dev, log)
    return out


# ---------------------------------------------------------------- phase 14
# the continuous batcher (serving/scheduler.py) at full width and depth:
# llama3_2_3b, 8 slots over a 1024-token capacity, the ladder's slot rungs
# 2, 4 and 8 and its prefill rungs up to 512 (and the capacity); mixed
# greedy traffic with no EOS, so slots turn over
CB_SLOTS, CB_CAP, CB_PAGE = 8, 1024, 16
CB_BUCKETS = (2, 4, 8, 64, 128, 256, 512)
CB_PROMPT, CB_GEN = (32, 480), (16, 96)        # drawn, both ends included
CB_REQUESTS, CB_SPEC_REQUESTS, CB_AFTER = 32, 8, 8
CB_SYSTEM, CB_PREFIX_REQUESTS = 256, 16        # a shared system prompt
CB_TENANTS = {"gold": 2.0, "bronze": 1.0}
# name -> (batcher options, traffic); "paged_tight" pools a third of the
# dense reservation, so admission waits on pages and requests are preempted
CB_RUNS = {
    "dense": (dict(cache_backend="dense"), "mixed"),
    "paged": (dict(cache_backend="paged", page_size=CB_PAGE), "mixed"),
    "paged_tight": (dict(cache_backend="paged", page_size=CB_PAGE,
                         num_pages=CB_SLOTS * (CB_CAP // CB_PAGE) // 3),
                    "mixed"),
    "prefix": (dict(cache_backend="paged", page_size=CB_PAGE,
                    prefix_cache=True, tenant_weights=CB_TENANTS), "prefix"),
}
# spec decode (phase 13's model, 2 MTP heads) on both backends
CB_SPEC_RUNS = {
    "spec_dense": (dict(cache_backend="dense", spec_decode=True,
                        spec_k=SPEC_K), "spec"),
    "spec_paged": (dict(cache_backend="paged", page_size=CB_PAGE,
                        spec_decode=True, spec_k=SPEC_K), "spec"),
}
# runs whose graphed batcher then takes a second seed's weights
CB_UPDATE = ("dense", "paged", "prefix")


def batcher_traffic(vocab: int, kind: str, seed: int, n: int = 0) -> list:
    """(prompt, max_new_tokens, tenant) for each request, drawn from
    ``seed``: "mixed" and "spec" prompts of CB_PROMPT tokens, "prefix"
    ones the shared CB_SYSTEM-token prompt and a user part (CB_PROMPT in
    all), alternating between CB_TENANTS. The lengths come from their own
    stream, so the schedule (there is no EOS) does not depend on
    ``vocab``: a small model on the CPU rehearses the card's."""
    lens, toks = np.random.RandomState(seed), np.random.RandomState(seed + 1)
    lo, hi = CB_PROMPT
    n = n or {"prefix": CB_PREFIX_REQUESTS, "spec": CB_SPEC_REQUESTS}.get(
        kind, CB_REQUESTS)
    if kind == "prefix":
        lo, hi = lo, hi - CB_SYSTEM
    shape = [(int(lens.randint(lo, hi + 1)),
              int(lens.randint(CB_GEN[0], CB_GEN[1] + 1))) for _ in range(n)]
    if kind != "prefix":
        return [(toks.randint(0, vocab, size=p), g, "default")
                for p, g in shape]
    system = toks.randint(0, vocab, size=CB_SYSTEM)
    tenants = list(CB_TENANTS)
    return [(np.concatenate([system, toks.randint(0, vocab, size=p)]), g,
             tenants[i % len(tenants)]) for i, (p, g) in enumerate(shape)]


def batcher_launches(cfg, cb) -> dict:
    """Kernel launches of a batcher's life so far, from its program calls
    (``cb.calls``, warmup's included): each prefill B2 L and B1 2L + 1
    (with the prefix cache a suffix prefill, whose attention is plain: no
    B2), each decode step B3 (dense) or B4 (paged) L and B1 2L + 1, each
    spec step spec_k MTP drafts (B2 1 and B1 5 each) and a verify (B1
    2L + 1, plain attention); B1's 2L + 1 a pass is :func:`step_norms`,
    for attention layers with dense or MoE FFNs."""
    L = cfg.num_layers
    pre, dec, spec = (cb.calls[k] for k in ("prefill", "decode", "spec"))
    want = {k: 0 for k in ops.KERNELS}
    want["flash_attention"] = (0 if cb.prefix_cache else L * pre) + \
        cb.spec_k * spec
    kernel = "decode_attention" if cb.backend == "dense" else \
        "paged_decode_attention"
    want[kernel] = L * dec
    want["rmsnorm"] = step_norms(cfg) * (pre + dec + spec) + \
        5 * cb.spec_k * spec
    return want


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def drain_batcher(cb, traffic, dev) -> dict:
    """Submit ``traffic`` and step ``cb`` until drained, timing each step
    (synchronised): its ms, the slot rung it decoded at, its prefills,
    whether admission waited on pages (a free slot and a queue, and no
    prefill), pages in use and reserved KV bytes after it; each request's
    tokens, preemptions, cached prompt tokens and admission latency (from
    submit to the end of the step that admitted it)."""
    reqs = [cb.submit(p, n, tenant=t) for p, n, t in traffic]
    steps, admitted = [], {}
    t0 = time.perf_counter()
    while cb.n_queued or any(r is not None for r in cb.active):
        free = sum(r is None for r in cb.active)
        queued, pre = cb.n_queued, cb.calls["prefill"]
        t = time.perf_counter()
        done = cb.step()
        _sync(dev)
        now = time.perf_counter()
        n_live = sum(r is not None for r in cb.active) + len(done)
        prefills = cb.calls["prefill"] - pre
        steps.append({
            "ms": (now - t) * 1e3, "prefills": prefills,
            "rung": cb.slot_ladder.fit(n_live) if cb.slot_ladder else cb.B,
            "waited": bool(free and queued and not prefills),
            "pages": cb.pm.stats.pages_in_use if cb.pm else None,
            "reserved": cb.kv_reserved_bytes()})
        for r in reqs:
            if r.out_tokens and r.rid not in admitted:
                admitted[r.rid] = now - r.t_submit
    wall = time.perf_counter() - t0
    return {"tokens": [list(r.out_tokens) for r in reqs],
            "want_len": [n for _, n, _ in traffic],
            "preempted": [r.n_preempted for r in reqs],
            "cached": [r.n_cached_tokens for r in reqs],
            "admit_s": [admitted[r.rid] for r in reqs],
            "steps": steps, "wall_s": wall}


def serve_batcher(model, cfg, params, kw, traffic, graphs: bool, dev,
                  update=None) -> dict:
    """One batcher (graphed, or eager with ``ContinuousBatcher._graphs``
    off) through warmup and ``traffic``: the drain's record, its launches
    (from 0 before construction) beside ``batcher_launches``, compile-cache
    stats, each graph's stats, and peak allocated bytes above what was
    live before construction. ``update`` = (params, traffic): then
    ``update_params`` and a second drain, recorded under "after"."""
    ContinuousBatcher._graphs = graphs
    try:
        gc.collect()
        _sync(dev)
        base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        cb = ContinuousBatcher(model, cfg, params, slots=CB_SLOTS,
                               capacity=CB_CAP, temperature=0.0, top_k=0,
                               seed=0, capture_buckets=CB_BUCKETS, **kw)
        _sync(dev)
        warm_s = time.perf_counter() - t0
        rec = drain_batcher(cb, traffic, dev)
        rec.update(
            warm_s=warm_s, graphs=cb.graph_stats(),
            launches=dict(ops.launches),
            want=batcher_launches(cfg, cb), calls=dict(cb.calls),
            cache=cb.compile_cache.stats(),
            peak_above=(torch.cuda.max_memory_allocated(dev) - base
                        if dev.type == "cuda" else None))
        if cb.pm is not None:
            cb.pm.check_invariants()
            rec["left_pages"] = cb.pm.stats.pages_in_use
            rec["parked_pages"] = cb.pm.num_cached_pages
            rec["hit_rate"] = cb.prefix_hit_rate()
        if update is not None:
            captures = cb.n_captures
            cb.update_params(update[0])
            rec["after"] = drain_batcher(cb, update[1], dev)
            rec["after"]["recaptures"] = cb.n_captures - captures
            rec["after"]["invalidations"] = \
                cb.pm.stats.n_prefix_invalidations if cb.pm else 0
        del cb
        return rec
    finally:
        ContinuousBatcher._graphs = True


def _check_batcher_run(name, rec, log):
    """Every request drained at its length, no recompile after warmup,
    launches as reckoned, and the pool empty (with the prefix cache, only
    its parked pages left)."""
    lens = [len(t) for t in rec["tokens"]]
    if lens != rec["want_len"]:
        raise SystemExit(f"batcher {name}: lengths {lens} != "
                         f"{rec['want_len']}")
    if rec["cache"]["recompiles"]:
        raise SystemExit(f"batcher {name}: {rec['cache']['recompiles']} "
                         f"recompiles after warmup")
    if rec["launches"] != rec["want"]:
        raise SystemExit(f"batcher {name}: launches {rec['launches']} != "
                         f"{rec['want']}")
    if "left_pages" in rec and rec["left_pages"] != rec["parked_pages"]:
        raise SystemExit(f"batcher {name}: {rec['left_pages']} pages in "
                         f"use after the drain, {rec['parked_pages']} parked")


def _same_run(name, graphed, eager):
    for key in ("tokens", "preempted", "cached", "launches", "calls"):
        if graphed[key] != eager[key]:
            raise SystemExit(f"batcher {name}: graphed {key} differ from "
                             f"eager")
    for key in ("pages", "rung", "prefills"):
        if [s[key] for s in graphed["steps"]] != \
                [s[key] for s in eager["steps"]]:
            raise SystemExit(f"batcher {name}: graphed steps' {key} differ "
                             f"from eager")


def _step_ms(rec) -> dict:
    """Mean ms of the steps that decoded at each rung and admitted
    nothing."""
    by = {}
    for s in rec["steps"]:
        if not s["prefills"]:
            by.setdefault(s["rung"], []).append(s["ms"])
    return {r: (sum(v) / len(v), len(v)) for r, v in sorted(by.items())}


def _print_batcher(name, g, e, dense_reserved, smi, log):
    tok = sum(len(t) for t in g["tokens"])
    ms_g, ms_e = _step_ms(g), _step_ms(e)
    rungs = ", ".join(f"{r}: {ms_g[r][0]:.3f} / {ms_e.get(r, (0.0,))[0]:.3f}"
                      f" ms (x{ms_g[r][1]})" for r in ms_g)
    lat = sorted(g["admit_s"])
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)]
    log(f"[smoke] batcher {name} [{smi}]: {len(g['tokens'])} requests, "
        f"{tok} tokens in {len(g['steps'])} steps, {g['wall_s']:.3f} s "
        f"graphed ({tok / g['wall_s']:.1f} tok/s) vs {e['wall_s']:.3f} s "
        f"eager ({tok / e['wall_s']:.1f} tok/s); warmup {g['warm_s']:.2f} "
        f"s; graphed / eager ms a decode-only step by slot rung: {rungs}")
    pages = [s["pages"] for s in g["steps"] if s["pages"] is not None]
    reserved = max(s["reserved"] for s in g["steps"])
    line = (f"[smoke] batcher {name} [{smi}]: admission latency p50 "
            f"{p50 * 1e3:.1f} "
            f"ms, p99 {p99 * 1e3:.1f} ms; kv_reserved_bytes peak "
            f"{reserved / 2**20:.1f} MiB (dense {dense_reserved / 2**20:.1f}"
            f" MiB); peak above the weights {g['peak_above'] / 2**20:.1f} MiB"
            f" graphed, {e['peak_above'] / 2**20:.1f} MiB eager; "
            f"preempted {sum(g['preempted'])}, waits on pages "
            f"{sum(s['waited'] for s in g['steps'])}")
    if pages:
        line += (f"; pages in use mean {sum(pages) / len(pages):.1f}, peak "
                 f"{max(pages)}")
    if any(g["cached"]):
        line += (f"; prefix hit rate {g['hit_rate']:.3f}, "
                 f"{g['parked_pages']} pages parked after")
    log(line)
    for key, st in g["graphs"].items():
        log(f"[smoke] batcher {name} graph {key} [{smi}]: capture "
            f"{st['capture_ms']:.1f} ms, pool "
            f"{st['pool_bytes'] / 2**20:.2f} MiB")


def _batcher_pair(name, model, cfg, params, kw, kind, dev, smi, log,
                  params2=None):
    """A run graphed then eager (with ``params2``: the update check) ->
    the graphed record, checked."""
    traffic = batcher_traffic(cfg.vocab_size, kind, seed=0)
    update = None
    if params2 is not None:
        update = (params2, batcher_traffic(
            cfg.vocab_size, kind, seed=0 if kind == "prefix" else 1,
            n=CB_AFTER))
    g = serve_batcher(model, cfg, params, kw, traffic, True, dev, update)
    e = serve_batcher(model, cfg, params, kw, traffic, False, dev)
    for rec in (g, e):
        _check_batcher_run(name, rec, log)
    _same_run(name, g, e)
    if not all(s["graphed"] and s["replays"] > 0
               for s in g["graphs"].values()):
        raise SystemExit(f"batcher {name}: a graph never replayed: "
                         f"{g['graphs']}")
    dense_reserved = sum(t.numel() * t.element_size() for t in leaves(
        model.init_cache(CB_SLOTS, CB_CAP, params["embed"].dtype, "meta")))
    _print_batcher(name, g, e, dense_reserved, smi, log)
    if update is not None:
        fresh = serve_batcher(model, cfg, params2, kw, update[1], False, dev)
        after = g.pop("after")
        if after["tokens"] != fresh["tokens"] or \
                after["cached"] != fresh["cached"]:
            raise SystemExit(f"batcher {name}: after update_params the "
                             f"tokens are not a fresh batcher's on the new "
                             f"weights")
        if kind == "prefix" and (after["cached"][0] or
                                 after["invalidations"] != 1):
            raise SystemExit(f"batcher {name}: the drain after "
                             f"update_params hit an old prefix")
        log(f"[smoke] batcher {name} [{smi}]: after update_params, "
            f"{CB_AFTER} requests on a second seed's weights = a fresh eager "
            f"batcher's tokens; {after['recaptures']} graphs recaptured"
            + (f"; first admission cached {after['cached'][0]} tokens, "
               f"{sum(after['cached'])} in all (fresh: "
               f"{sum(fresh['cached'])})" if kind == "prefix" else ""))
        g["after"] = {k: after[k] for k in ("recaptures", "cached")}
    return g


def suffix_prefill_ms(model, cfg, params, dev, prompt=CB_PROMPT[1],
                     reps=5) -> dict:
    """A cold prefill of one ``prompt``-token request padded to its rung,
    two ways: the paged prefill (B2) and the prefix cache's suffix
    prefill from position 0 (its attention plain: a masked fp32 softmax
    of every query over the gathered pages) -> synchronised ms of each
    (the mean of ``reps`` after a warm call) and their logits' largest
    difference."""
    Sb = next(b for b in CB_BUCKETS if b >= prompt)
    nb = CB_CAP // CB_PAGE
    pm = PageManager(nb, CB_PAGE)
    pm.allocate(0, prompt)
    pools = model.init_paged_pools(nb, CB_PAGE, params["embed"].dtype)
    bt = torch.from_numpy(pm.block_table_array([0], nb)).to(dev)
    tokens = torch.zeros((1, Sb), dtype=torch.long, device=dev)
    tokens[0, :prompt] = torch.randint(
        0, cfg.vocab_size, (prompt,), device=dev,
        generator=torch.Generator(device=dev).manual_seed(7))
    lens = torch.full((1,), prompt, dtype=torch.int32, device=dev)
    start = torch.zeros((1,), dtype=torch.int32, device=dev)
    runs = {"flash": lambda: model.paged_prefill(
                params, {"tokens": tokens}, pools, bt, lens)[0],
            "suffix": lambda: model.paged_prefill_suffix(
                params, {"tokens": tokens}, pools, bt, start, lens)[0]}
    out, logits = {}, {}
    for name, fn in runs.items():
        logits[name] = fn().float()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(dev)
        out[name] = (time.perf_counter() - t0) * 1e3 / reps
    out["max_logit_diff"] = (logits["flash"] - logits["suffix"]).abs() \
        .max().item()
    return out


def graph_pool_mib(model, cfg, params, kw, dev) -> dict:
    """The bytes a batcher's warmup captures add to the allocator's
    reserve, summed over its graphs (MiB): with the batcher's one shared
    pool, and with each graph in a private pool
    (``torch.cuda.graph_pool_handle`` stood in for by None, so every
    capture takes its own)."""
    out = {}
    for name in ("shared", "private"):
        handle = torch.cuda.graph_pool_handle
        if name == "private":
            torch.cuda.graph_pool_handle = lambda: None
        try:
            gc.collect()
            torch.cuda.empty_cache()
            cb = ContinuousBatcher(model, cfg, params, slots=CB_SLOTS,
                                   capacity=CB_CAP, temperature=0.0,
                                   capture_buckets=CB_BUCKETS, **kw)
            out[name] = sum(st["pool_bytes"] for st in
                            cb.graph_stats().values()) / 2**20
            del cb
        finally:
            torch.cuda.graph_pool_handle = handle
    return out


def check_small_batcher_against_cpu(dev, seed=3) -> dict:
    """A small f32 model (the GQA smoke model with 2 MTP heads) served by
    the batcher on the card through the kernels and on the CPU through the
    plain versions, greedy: the same tokens, on both backends, with the
    prefix cache and with spec decode."""
    cfg = dataclasses.replace(get_config("llama3_2_3b").smoke(),
                              num_kv_heads=2, mtp_depth=SPEC_DEPTH)
    cpu_model = Model(cfg, device="cpu")
    params = cpu_model.init(torch.Generator().manual_seed(seed))
    gpu_model = Model(cfg, device=dev)
    gparams = _to(params, dev)
    rng = np.random.RandomState(seed)
    system = rng.randint(0, cfg.vocab_size, size=32)
    prompts = [np.concatenate([system, rng.randint(
        0, cfg.vocab_size, size=int(rng.randint(4, 40)))]) for _ in range(6)]
    gens = [int(rng.randint(6, 20)) for _ in prompts]
    out = {}
    for name, kw in (("dense", dict(cache_backend="dense")),
                     ("paged", dict(cache_backend="paged", page_size=16)),
                     ("prefix", dict(cache_backend="paged", page_size=16,
                                     prefix_cache=True)),
                     ("spec_dense", dict(spec_decode=True, spec_k=SPEC_K)),
                     ("spec_paged", dict(cache_backend="paged", page_size=16,
                                         spec_decode=True, spec_k=SPEC_K))):
        toks = []
        for model, p in ((cpu_model, params), (gpu_model, gparams)):
            cb = ContinuousBatcher(model, cfg, p, slots=3, capacity=96,
                                   temperature=0.0, seed=0,
                                   capture_buckets=(2, 4, 16, 32, 64), **kw)
            reqs = [cb.submit(q, n) for q, n in zip(prompts, gens)]
            cb.run_until_drained()
            toks.append([r.out_tokens for r in reqs])
        if toks[0] != toks[1]:
            raise SystemExit(f"small batcher {name}: card tokens differ from "
                             f"the CPU's")
        out[name] = sum(len(t) for t in toks[1])
    return out


def continuous_batching(dev, log) -> dict:
    """Phase 14: the continuous batcher at full width and depth (see the
    module's note); returns each run's graphed record."""
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).strip()
    cfg = get_config("llama3_2_3b")
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    params2 = model.init(torch.Generator(device=dev).manual_seed(1))
    out = {}
    for name, (kw, kind) in CB_RUNS.items():
        out[name] = _batcher_pair(name, model, cfg, params, kw, kind, dev,
                                  smi, log, params2 if name in CB_UPDATE
                                  else None)
    if not sum(out["paged_tight"]["preempted"]) or \
            not any(s["waited"] for s in out["paged_tight"]["steps"]):
        raise SystemExit("batcher paged_tight: no preemption or no wait "
                         "on pages")
    pre = suffix_prefill_ms(model, cfg, params, dev)
    log(f"[smoke] batcher prefill of {CB_PROMPT[1]} tokens (rung 512) "
        f"[{smi}]: paged (B2) {pre['flash']:.3f} ms, prefix-cache suffix "
        f"from 0 (plain attention) {pre['suffix']:.3f} ms "
        f"({pre['suffix'] / pre['flash']:.2f}x); logits differ by "
        f"{pre['max_logit_diff']:.3e}")
    out["prefill_ms"] = pre
    del params, params2, model
    gc.collect()
    torch.cuda.empty_cache()
    scfg = dataclasses.replace(cfg, mtp_depth=SPEC_DEPTH)
    model = Model(scfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    for name, (kw, kind) in CB_SPEC_RUNS.items():
        out[name] = _batcher_pair(name, model, scfg, params, kw, kind, dev,
                                  smi, log)
    pools = graph_pool_mib(model, scfg, params, CB_SPEC_RUNS["spec_paged"][0],
                           dev)
    log(f"[smoke] batcher spec_paged graphs' pools [{smi}]: "
        f"{pools['shared']:.2f} MiB shared, {pools['private']:.2f} MiB "
        f"private")
    out["graph_pool_mib"] = pools
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    small = check_small_batcher_against_cpu(dev)
    runs = ", ".join(f"{k} ({v} tokens)" for k, v in small.items())
    log(f"[smoke] small batcher card vs CPU [{smi}]: greedy tokens "
        f"identical on {runs}")
    for name in (*CB_RUNS, *CB_SPEC_RUNS):
        out[name].pop("steps")
        out[name].pop("tokens")
    return out


# each wrapper's CUDA kernels, by function name (no name contains
# another's): one launch of the first kind per call; B3 and B4 add their
# combine kernel when they split, B2-bwd its dK/dV and prep (or delta)
# kernels,
# B1-bwd its dscale sum kernel when asked for dscale
KERNEL_FUNCS = {"flash_attention": ("flash_wgmma_kernel", "flash_fwd_kernel"),
                "decode_attention": ("decode_split_kernel",),
                "paged_decode_attention": ("paged_split_kernel",),
                "rmsnorm": ("rmsnorm_vec_kernel", "rmsnorm_scalar_kernel"),
                "ssd_scan": ("ssd_wgmma_kernel", "ssd_scan_kernel"),
                "flash_attention_bwd": ("flash_bwd_dq_wgmma_kernel",
                                        "flash_bwd_dq_kernel"),
                "rmsnorm_bwd": ("rmsnorm_bwd_vec_kernel",
                                "rmsnorm_bwd_scalar_kernel")}
SECOND_KERNELS = {"decode_attention": ("combine_kernel",),
                  "paged_decode_attention": ("paged_merge_kernel",),
                  "flash_attention_bwd": ("flash_bwd_dkdv_wgmma_kernel",
                                          "flash_bwd_prep_kernel",
                                          "flash_bwd_dkdv_kernel",
                                          "flash_bwd_delta_kernel"),
                  "rmsnorm_bwd": ("rmsnorm_dscale_sum_kernel",)}


# --------------------------------------------------------------- phase 15
# ZeRO: the runs over NCCL at ndp 1 (stage, gather mode) on both engines,
# and the ranks, prompts and runs over gloo on the one card
ZERO_NCCL_RUNS = ((1, "layer"), (3, "layer"))
# iterations of each NCCL run, held to the unsharded first ones, metrics
# and then the trained trees by fingerprint (one, to leave the script room
# for phase 20)
ZERO_NCCL_ITERS = 1
ZERO_NDP, ZERO_PROMPTS = 2, 7
ZERO_GLOO_RUNS = ((1, "tree"), (3, "tree"), (3, "layer"))
# one iteration a gloo run (two ranks share the card and every gathered
# byte crosses loopback TCP: 9-26 s an iteration at full depth); what its
# sharded update left is held to the one rank's by a fingerprint of the
# gathered trees. The gloo runs, their one-rank baseline and the
# simulator's predictions take the OPT pair at STUDY_LAYERS of its 24
# layers (``_study_pair``), to leave the script room for phase 19; the
# NCCL runs stay at full depth, held to phases 7 and 8
ZERO_GLOO_ITERS = 1
ZERO_JOIN_S = 420          # a hung rendezvous or rank fails in this time
ZERO_LAYER_MARGIN = 0.5    # layer peaks below tree by this share of (tree
                           # - one layer) of the actor


def _init_group(backend, world, rank, path):
    import datetime

    import torch.distributed as dist
    dist.init_process_group(backend, store=dist.FileStore(path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))


def _zero_trainer(engine, dev, shard, policy="after_inference", pair=None):
    """Phase 7's hydra trainer or phase 8's separate one (on ``pair``, the
    OPT pair by default), seed 0, on ``shard``."""
    g = torch.Generator(device=dev).manual_seed(0)
    if engine == "hydra":
        cfg = get_config("llama3_2_3b")
        return RLHFTrainer(cfg, cfg, RLHFConfig(memory_policy=policy,
                                                **PPO_KW), g, shard=shard)
    actor, critic = pair or (get_config(SEP_ACTOR), get_config(SEP_CRITIC))
    return RLHFTrainer(actor, critic,
                       RLHFConfig(engine="separate", memory_policy=policy,
                                  **SEP_KW), g, shard=shard)


def _tp_pair():
    """Phase 16's OPT pair: full width, TP_LAYERS of its 24 layers."""
    return tuple(dataclasses.replace(get_config(n), num_layers=TP_LAYERS)
                 for n in (SEP_ACTOR, SEP_CRITIC))


def _zero_prompts(engine, dev, it, n=None):
    """Phase 7's or phase 8's prompts of iteration ``it`` (the first
    ``n``)."""
    if engine == "hydra":
        cfg = get_config("llama3_2_3b")
        data = PromptDataset(synthetic_instruction_prompts(
            PBATCH * PITERS, seed=1), PPROMPT).batches(PBATCH, seed=1)
        for _ in range(it):
            next(data)
        p = torch.from_numpy(next(data) % cfg.vocab_size).long().to(dev)
    else:
        p = _sep_prompts(dev, 1 + it, get_config(SEP_ACTOR).vocab_size)
    return p if n is None else p[:n]


def _zero_want(tr, engine):
    if engine == "hydra":
        return ppo_launches(tr.actor_cfg, tr.rl, model_reward=True)
    return ppo_launches(tr.actor_cfg, tr.rl, model_reward=True,
                        critic_cfg=tr.critic_cfg)


def _zero_iterations(tr, engine, dev, n=None, iters=2):
    """``iters`` asserted iterations (phase 7/8's prompts and generator)
    -> per iteration (seconds, metrics, its records)."""
    g = torch.Generator(device=dev).manual_seed(7)
    want = _zero_want(tr, engine)
    nrec = 8 if engine == "hydra" else 7
    out = []
    for it in range(iters):
        secs, m, _, recs = _run_ppo(tr, _zero_prompts(engine, dev, it, n), g,
                                    want, f"zero {engine} iteration {it}",
                                    nrec)
        out.append((secs, m, recs))
    return out


def _fingerprint(tree) -> list:
    """Per leaf, two sums over its raw bits (plain and weighted by the
    element's position), on the card: equal trees give equal lists."""
    out = []
    for t in leaves(tree):
        t = t.detach().contiguous()
        v = t.view(torch.int16 if t.element_size() == 2 else torch.int32
                   ).reshape(-1).to(torch.int64)
        w = torch.arange(v.numel(), device=v.device) % 1_000_003 + 1
        out.append((int(v.sum()), int((v * w).sum())))
        del v, w
    return out


def _trained_fingerprint(tr) -> list:
    """:func:`_fingerprint` of the trees a PPO iteration trains, whole: the
    separate engine's actor and critic, the hydra engine's actor and
    critic adapters (a ZeRO-3 rank gathers them: a collective every rank
    runs)."""
    _, actor_plan, critic_plan, _ = tr._plans()
    out = []
    for plan, tree in ((actor_plan, tr.actor_state["params"]),
                       (critic_plan, tr.critic_state["params"])):
        full, owned = (tree, False) if plan is None else \
            plan.gather_copy(tree)
        out += _fingerprint(full)
        if owned:
            delete_tree(full)
    return out


def _zero_rank_stats(tr, runs) -> dict:
    """One rank's numbers of a run: persistent bytes on this rank and the
    largest over the ranks, per phase (the last iteration's records) the
    allocator's peak and reserved - allocated, the train phases' peak,
    iteration seconds and metrics."""
    recs = runs[-1][2]
    trees = tr.persistent_trees()
    train = [r["peak_bytes"] for r in recs if r["kind"] == "training"]
    comm = None if tr.shard is None else tr.shard.comm
    return {"state_bytes": tree_nbytes(list(trees.values())),
            "state_bytes_max": tr.per_device_state_bytes(),
            "actor_bytes": tree_nbytes(trees["actor_params"]),
            "peaks": {r["phase"]: r["peak_bytes"] for r in recs},
            "slack": {r["phase"]: r["reserved_bytes"] - r["live_bytes"]
                      for r in recs},
            "train_peak": max(train),
            "seconds": [secs for secs, _, _ in runs],
            "metrics": [m for _, m, _ in runs],
            "staged_bytes": 0 if comm is None else comm.staged_bytes,
            "launches": dict(ops.launches),
            "trained": _trained_fingerprint(tr)}


def _zero_rank(rank, world, path, queue):
    """One gloo rank of phase 15 (b), on ``cuda:0`` beside the other: the
    three ``ZERO_GLOO_RUNS`` on the separate pair, 7 prompts."""
    try:
        import torch.distributed as dist
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda")
        _init_group("gloo", world, rank, path)
        out = {}
        for stage, mode in ZERO_GLOO_RUNS:
            sc = ShardedContext.create(world, zero_stage=stage,
                                       gather_mode=mode, device="cuda",
                                       backend="gloo")
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tr = _zero_trainer("separate", dev, sc, pair=_study_pair())
            init_s = time.perf_counter() - t0
            runs = _zero_iterations(tr, "separate", dev, n=ZERO_PROMPTS,
                                    iters=ZERO_GLOO_ITERS)
            st = _zero_rank_stats(tr, runs)
            st["init_s"] = init_s
            out[f"{stage}-{mode}"] = st
            del tr, runs, sc
            gc.collect()
            torch.cuda.empty_cache()
        dist.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException as e:       # reported to the parent, which fails
        import traceback
        queue.put((rank, None, f"{e!r}\n{traceback.format_exc()}"))


def _sim_state(trees_by_name, engine, stage, mode, ndp,
               pair=None) -> float:
    """The simulator's persistent bytes a rank: each state group's bytes
    at its fraction traced from the spec trees (``traced_zero_scales``) of
    the separate engine's ``pair`` (phase 8's OPT pair by default)."""
    if engine == "hydra":
        cfgs = (get_config("llama3_2_3b"), None)
        kw = dict(lora_rank=PPO_KW["lora_rank"])
    else:
        cfgs = pair or (get_config(SEP_ACTOR), get_config(SEP_CRITIC))
        kw = {}
    frac = dict(traced_zero_scales(*cfgs, ndp=ndp, zero_stage=stage,
                                   engine=engine, gather_mode=mode, **kw))
    return sum(b * frac[f"{k}:{'opt' if k.endswith('_opt') else 'param'}"]
               for k, b in trees_by_name.items())


def _zero_sim(tr_plain, stage, mode, ndp, ph_per) -> dict:
    """The traced simulator's one-rank prediction of a separate run on
    ``_study_pair()``: persistent state bytes and the train phases' peak,
    policy after_inference."""
    ph, per = ph_per
    strat = traced_strategy(
        MemoryStrategy(f"zero-{stage}", zero_stage=stage, gather_mode=mode),
        *_study_pair(), ndp=ndp, engine="separate")
    r = run_iteration(ph, per, strat, "after_inference", ndp=ndp,
                      trainable_fraction=1.0, capacity=None)
    train = max(rec.alloc_peak for rec in r.phase_records
                if rec.name.startswith("train"))
    return {"state_bytes": _sim_state(tr_plain["state_by_name"], "separate",
                                      stage, mode, ndp, _study_pair()),
            "train_peak": train}


def zero_ppo(dev, log, hydra_plain=None, sep_plain=None) -> dict:
    """Phase 15: ZeRO on the card (the module docstring). ``hydra_plain``
    and ``sep_plain`` are phase 7's and phase 8's unsharded runs: (metrics
    a iteration, :func:`_trained_fingerprint` after ZERO_NCCL_ITERS); run
    alone (None) the phase runs them itself."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp
    out = {"nccl": {}, "gloo": {}}
    t_phase = time.perf_counter()
    # (a) NCCL, ndp 1: the multi-card path's code at one rank
    torch.cuda.set_device(0)
    tmp = tempfile.mkdtemp(prefix="zero-")
    _init_group("nccl", 1, 0, os.path.join(tmp, "nccl"))
    try:
        for engine, plain in (("separate", sep_plain),
                              ("hydra", hydra_plain)):
            if plain is None:
                tr = _zero_trainer(engine, dev, None)
                plain = ([m for _, m, _ in _zero_iterations(
                    tr, engine, dev, iters=ZERO_NCCL_ITERS)],
                    _trained_fingerprint(tr))
                del tr
                gc.collect()
                torch.cuda.empty_cache()
            plain, trained = plain[0][:ZERO_NCCL_ITERS], plain[1]
            for stage, mode in ZERO_NCCL_RUNS:
                sc = ShardedContext.create(1, zero_stage=stage,
                                           gather_mode=mode, device="cuda")
                tr = _zero_trainer(engine, dev, sc)
                runs = _zero_iterations(tr, engine, dev,
                                        iters=ZERO_NCCL_ITERS)
                got = [m for _, m, _ in runs]
                if got != plain:
                    raise SystemExit(f"zero nccl {engine} ZeRO-{stage} "
                                     f"{mode}: metrics {got} != unsharded "
                                     f"{plain}")
                fp = _trained_fingerprint(tr)
                if fp != trained:
                    bad = sum(a != b for a, b in zip(fp, trained))
                    raise SystemExit(f"zero nccl {engine} ZeRO-{stage} "
                                     f"{mode}: {bad} of {len(fp)} trained "
                                     f"leaves differ from the unsharded run's")
                key = f"{engine}-{stage}-{mode}"
                sim = _sim_state({k: tree_nbytes(v) for k, v in
                                  tr.persistent_trees().items()},
                                 engine, stage, mode, 1)
                out["nccl"][key] = {
                    "seconds": [secs for secs, _, _ in runs],
                    "state_bytes": tr.per_device_state_bytes(),
                    "sim_state_bytes": sim,
                    "launches": dict(ops.launches)}
                log(f"[smoke] zero nccl run {engine} ZeRO-{stage} {mode} ndp "
                    f"1: metrics and trained trees bit for bit unsharded, "
                    f"launches as phases "
                    f"7/8 {out['nccl'][key]['launches']}; "
                    f"{', '.join(f'{s * 1e3:.1f}' for s, _, _ in runs)} ms"
                    f" an iteration, state {out['nccl'][key]['state_bytes']}"
                    f" bytes a rank (sim {sim:.0f})")
                del tr, runs, sc
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # (b) gloo, ndp 2 on the one card: first the one-rank run of the same
    # 7 prompts, then the two ranks
    torch.cuda.reset_peak_memory_stats()
    tr = _zero_trainer("separate", dev, None, pair=_study_pair())
    runs = _zero_iterations(tr, "separate", dev, n=ZERO_PROMPTS,
                            iters=ZERO_GLOO_ITERS)
    one = _zero_rank_stats(tr, runs)
    one["state_by_name"] = {k: tree_nbytes(v) for k, v in
                            tr.persistent_trees().items()}
    layer_bytes = tree_nbytes(tr.actor_state["params"]["layers"][0])
    del tr, runs
    gc.collect()
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = os.path.join(tmp, "gloo")
    procs = [ctx.Process(target=_zero_rank, args=(r, ZERO_NDP, store, queue))
             for r in range(ZERO_NDP)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        # the simulator's predictions, on the host while the ranks run
        t1 = time.perf_counter()
        ph_per = build_rlhf_phases(
            *_study_pair(), batch=ZERO_PROMPTS, prompt_len=SPROMPT,
            gen_len=SGEN, engine="separate", min_bytes=2048)
        sim1 = _zero_sim(one, 0, "tree", 1, ph_per)
        sims = {f"{s}-{m}": _zero_sim(one, s, m, ZERO_NDP, ph_per)
                for s, m in ZERO_GLOO_RUNS}
        del ph_per
        out["sim_seconds"] = time.perf_counter() - t1
        log(f"[smoke] zero gloo run separate ndp 1 ({ZERO_PROMPTS} prompts):"
            f" state {one['state_bytes']} bytes (sim "
            f"{sim1['state_bytes']:.0f}), train peak {one['train_peak']} "
            f"(sim {sim1['train_peak']}), peaks " + ", ".join(
                f"{k} {v / MIB:.0f}" for k, v in one["peaks"].items())
            + " MiB, reserved-allocated " + ", ".join(
                f"{k} {v / MIB:.0f}" for k, v in one["slack"].items())
            + f" MiB; {', '.join(f'{s * 1e3:.1f}' for s in one['seconds'])}"
            f" ms an iteration")
        while len(got) < ZERO_NDP:
            if time.perf_counter() - t0 > ZERO_JOIN_S:
                raise SystemExit(f"zero gloo: ranks {sorted(got)} reported "
                                 f"of {ZERO_NDP} in {ZERO_JOIN_S} s")
            try:
                rank, res, err = queue.get(timeout=5.0)
            except Exception:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise SystemExit(f"zero gloo: ranks {dead} exited "
                                     f"without a result")
                continue
            if err is not None:
                raise SystemExit(f"zero gloo rank {rank} failed: {err}")
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    out["gloo_seconds"] = time.perf_counter() - t0
    for key in (f"{s}-{m}" for s, m in ZERO_GLOO_RUNS):
        ranks = [got[r][key] for r in range(ZERO_NDP)]
        for r, st in enumerate(ranks):
            if st["metrics"] != one["metrics"]:
                raise SystemExit(f"zero gloo {key} rank {r}: metrics "
                                 f"{st['metrics']} != one rank's "
                                 f"{one['metrics']}")
            if st["trained"] != one["trained"]:
                raise SystemExit(f"zero gloo {key} rank {r}: the trained "
                                 f"trees differ from one rank's")
            log(f"[smoke] zero gloo run separate ZeRO-{key} ndp {ZERO_NDP} "
                f"rank {r}: state {st['state_bytes']} bytes (max over ranks "
                f"{st['state_bytes_max']}; sim {sims[key]['state_bytes']:.0f})"
                f", train peak {st['train_peak']} (sim "
                f"{sims[key]['train_peak']}), peaks " + ", ".join(
                    f"{k} {v / MIB:.0f}" for k, v in st["peaks"].items())
                + " MiB, reserved-allocated " + ", ".join(
                    f"{k} {v / MIB:.0f}" for k, v in st["slack"].items())
                + f" MiB; {', '.join(f'{s * 1e3:.1f}' for s in st['seconds'])}"
                f" ms an iteration, init {st['init_s']:.1f} s, staged "
                f"{st['staged_bytes'] / 1e9:.2f} GB")
        out["gloo"][key] = {"ranks": ranks, "sim": sims[key]}
    cut = max(got[r]["3-tree"]["state_bytes"] for r in got) / \
        one["state_bytes"]
    if cut > 0.55:
        raise SystemExit(f"zero gloo: ZeRO-3 keeps {cut:.3f} of ndp 1's "
                         f"persistent bytes on a rank (at most 0.55)")
    need = ZERO_LAYER_MARGIN * (one["actor_bytes"] - layer_bytes)
    for r in got:
        tree, layer = got[r]["3-tree"]["train_peak"], \
            got[r]["3-layer"]["train_peak"]
        if not tree - layer >= need:
            raise SystemExit(f"zero gloo rank {r}: layer train peak {layer} "
                             f"not below tree's {tree} by {need:.0f}")
    out["state_cut"] = cut
    out["layer_margin_bytes"] = need
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[smoke] zero: ZeRO-3 keeps {cut:.4f} of ndp 1's persistent bytes "
        f"a rank; layer peaks below tree by >= {need / MIB:.0f} MiB; phase "
        f"15 {out['seconds']:.1f} s (gloo ranks {out['gloo_seconds']:.1f} s,"
        f" simulator {out['sim_seconds']:.1f} s)")
    return out


# ---------------------------------------------------------------- phase 16
TP_NTP = 2
TP_JOIN_S = 600            # a hung rendezvous or rank fails in this time
TP_CUT = 0.55              # a rank's persistent bytes at most this of ntp 1
TP_SIM_TOL = 1e-3          # ... and within this of the traced prediction
TP_ERR_RATIO = 2.0         # TP's log-prob RMS error at most this x ntp 1's
# phase 16's batcher: llama3_2_3b, 4 slots over 640 tokens, 3 greedy
# requests of phase 14's mixed traffic cut to at most 24 new tokens each,
# dense and paged (an eager TP decode step stages ~58 collectives)
TP_CB = dict(slots=4, capacity=640, temperature=0.0)
TP_CB_REQUESTS, TP_CB_GEN = 3, 24


def _teacher_logp(model, params, tokens):
    """Per-action fp32 log-probs of ``tokens`` under ``params`` (teacher
    forced, one full-sequence forward; under an ambient TP group from
    vocab-sharded logits)."""
    with torch.no_grad():
        return TS._action_logp(model.forward(params, {"tokens": tokens})[0],
                               tokens).float()


def _rms(a, b, mask) -> float:
    return float(torch.sqrt(((a - b) ** 2 * mask).sum() / mask.sum()))


class _SkipRowAllReduce:
    """The planted fault: the first row-site all-reduce after entry is
    skipped (its partial product kept), on every rank alike."""

    def __init__(self, tp):
        self.tp, self.skipped = tp, 0

    def __enter__(self):
        plain = self.tp._all_reduce

        def patched(x, site):
            if site == "row" and not self.skipped:
                self.skipped += 1
                return x.clone()
            return plain(x, site)

        self.tp._all_reduce = patched
        return self

    def __exit__(self, *exc):
        del self.tp._all_reduce


def _tp_batcher(sc, dev) -> dict:
    """Phase 16 (b) on one rank: llama3_2_3b at full width, the whole tree
    drawn from seed 0 and cut to this rank's, served by
    ``ContinuousBatcher(mesh=sc)`` dense and paged (decode eager)."""
    cfg = get_config("llama3_2_3b")
    model = Model(cfg, device=dev)
    plan = sc.plan_params(cfg, Model(cfg, device="meta").init())
    params = plan.place_params(model.init(
        torch.Generator(device=dev).manual_seed(0)))
    gc.collect()
    torch.cuda.empty_cache()
    traffic = [(p, min(n, TP_CB_GEN), t) for p, n, t in batcher_traffic(
        cfg.vocab_size, "mixed", 16, TP_CB_REQUESTS)]
    out = {"param_bytes": tree_nbytes(params)}
    for backend in ("dense", "paged"):
        ops.reset_launches()
        sc.tp.reset_counts()
        staged = sc.tp.comm.staged_bytes
        kw = dict(TP_CB, cache_backend=backend)
        if backend == "paged":
            kw["page_size"] = CB_PAGE
        cb = ContinuousBatcher(model, cfg, params, mesh=sc, **kw)
        run = drain_batcher(cb, traffic, dev)
        made, want = dict(ops.launches), batcher_launches(cfg, cb)
        if made != want:
            raise SystemExit(f"tp batcher {backend}: launches {made} != "
                             f"{want}")
        for toks, n in zip(run["tokens"], run["want_len"]):
            if len(toks) != n or not all(0 <= t < cfg.vocab_size
                                         for t in toks):
                raise SystemExit(f"tp batcher {backend}: a request of "
                                 f"{len(toks)} tokens, {n} asked")
        kv = cb.pm.bytes_per_token if backend == "paged" else sum(
            c[n].numel() * c[n].element_size()
            for c in cb.caches["layers"] for n in ("k", "v"))
        decode = [s["ms"] for s in run["steps"] if not s["prefills"]]
        out[backend] = {"launches": made, "kv": kv,
                        "steps": len(run["steps"]), "wall_s": run["wall_s"],
                        "decode_ms": float(np.median(decode)),
                        "counts": dict(sc.tp.counts),
                        "staged_bytes": sc.tp.comm.staged_bytes - staged,
                        "tokens": run["tokens"]}
        del cb
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _tp_rank(rank, world, path, tokens, queue):
    """One gloo rank of phase 16, on ``cuda:0`` beside the other: (a) one
    separate OPT-pair iteration at (ndp 1, ntp 2), then the reference
    actor teacher-forced on the one-rank rollout's ``tokens``, clean and
    with a row all-reduce skipped; (b) the batcher drains."""
    try:
        import torch.distributed as dist

        from repro_torch.sharding import use_mesh
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda")
        _init_group("gloo", world, rank, path)
        sc = ShardedContext.create(
            1, zero_stage=0, model=world, device="cuda", backend="gloo",
            cfg=_tp_pair())
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = _zero_trainer("separate", dev, sc, pair=_tp_pair())
        init_s = time.perf_counter() - t0
        sc.tp.reset_counts()
        staged = (sc.comm.staged_bytes, sc.tp.comm.staged_bytes)
        runs = _zero_iterations(tr, "separate", dev, iters=1)
        st = _zero_rank_stats(tr, runs)
        st.update(init_s=init_s, counts=dict(sc.tp.counts),
                  tp_staged_bytes=sc.tp.comm.staged_bytes - staged[1],
                  dp_staged_bytes=sc.comm.staged_bytes - staged[0],
                  state_by_name={k: tree_nbytes(v) for k, v in
                                 tr.persistent_trees().items()})
        st.pop("trained")
        toks = tokens.to(dev)
        with use_mesh(sc):
            # numpy: a tensor sent to the parent needs this process alive
            st["logp"] = _teacher_logp(tr.actor, tr.ref_params,
                                       toks).cpu().numpy()
            with _SkipRowAllReduce(sc.tp) as plant:
                st["logp_fault"] = _teacher_logp(tr.actor, tr.ref_params,
                                                 toks).cpu().numpy()
            if plant.skipped != 1:
                raise SystemExit("tp: the planted fault skipped "
                                 f"{plant.skipped} all-reduces")
        del tr, runs, toks
        gc.collect()
        torch.cuda.empty_cache()
        st["batcher"] = _tp_batcher(sc, dev)
        dist.destroy_process_group()
        queue.put((rank, st, None))
    except BaseException as e:       # reported to the parent, which fails
        import traceback
        queue.put((rank, None, f"{e!r}\n{traceback.format_exc()}"))


def tp_ppo(dev, log) -> dict:
    """Phase 16: Megatron tensor parallelism on the card, two gloo ranks
    sharing ``cuda:0`` at (ndp 1, ntp 2) (the module docstring). First the
    one-rank numbers on this process: phase 8's pair's persistent bytes by
    tree, a rollout of its initial actor on phase 8's first prompts, and
    that actor's log-probs of those tokens in bf16 and in fp32."""
    import tempfile

    import torch.multiprocessing as mp
    from repro_torch.paged import pool_token_bytes
    t_phase = time.perf_counter()
    out = {}
    pair = _tp_pair()
    tr = _separate_trainer(dev, "after_inference", pair=pair)[0]
    by_name = {k: tree_nbytes(v) for k, v in tr.persistent_trees().items()}
    state = sum(by_name.values())
    g = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad():
        ro = tr.rollout.generate(tr.ref_params, {"tokens": _zero_prompts(
            "separate", dev, 0)}, SGEN, g)
    tokens, mask = ro.tokens, ro.mask
    del ro
    lp1 = _teacher_logp(tr.actor, tr.ref_params, tokens)
    p32 = tree_map(lambda t: t.float(), tr.ref_params)
    lp32 = _teacher_logp(tr.actor, p32, tokens)
    err1 = _rms(lp1, lp32, mask)
    del tr, p32, lp1
    gc.collect()
    torch.cuda.empty_cache()
    llama = get_config("llama3_2_3b")
    hd = llama.resolved_head_dim()
    kv1 = {"dense": 2 * llama.num_layers * TP_CB["slots"] *
           TP_CB["capacity"] * llama.num_kv_heads * hd * 2,
           "paged": pool_token_bytes(llama, torch.bfloat16) *
           llama.num_layers}
    frac = dict(traced_zero_scales(*pair, ndp=1,
                                   zero_stage=0, engine="separate",
                                   ntp=TP_NTP))
    sim = sum(b * frac[f"{k}:{'opt' if k.endswith('_opt') else 'param'}"]
              for k, b in by_name.items())
    tmp = tempfile.mkdtemp(prefix="tp-")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_tp_rank, args=(
        r, TP_NTP, os.path.join(tmp, "gloo"), tokens.cpu(), queue))
        for r in range(TP_NTP)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < TP_NTP:
            if time.perf_counter() - t0 > TP_JOIN_S:
                raise SystemExit(f"tp: ranks {sorted(got)} reported of "
                                 f"{TP_NTP} in {TP_JOIN_S} s")
            try:
                rank, res, err = queue.get(timeout=5.0)
            except Exception:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise SystemExit(f"tp: ranks {dead} exited without a "
                                     "result")
                continue
            if err is not None:
                raise SystemExit(f"tp rank {rank} failed: {err}")
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    out["ranks_seconds"] = time.perf_counter() - t0
    mask = mask.cpu()
    lp32 = lp32.cpu()
    ranks = []
    for r in range(TP_NTP):
        st = got[r]
        err = _rms(torch.from_numpy(st.pop("logp")), lp32, mask)
        fault = _rms(torch.from_numpy(st.pop("logp_fault")), lp32, mask)
        cut = st["state_bytes"] / state
        st.update(err=err, fault_err=fault, ratio=err / err1,
                  fault_ratio=fault / err1, state_cut=cut, sim_state=sim)
        if not st["ratio"] <= TP_ERR_RATIO:
            raise SystemExit(f"tp rank {r}: log-prob RMS error {err:.4e} is "
                             f"{st['ratio']:.2f}x ntp 1's {err1:.4e}")
        if st["fault_ratio"] <= TP_ERR_RATIO:
            raise SystemExit(f"tp rank {r}: a skipped row all-reduce passed "
                             f"the check ({st['fault_ratio']:.2f}x)")
        if cut > TP_CUT:
            raise SystemExit(f"tp rank {r}: persistent state {cut:.4f} of "
                             f"ntp 1's (at most {TP_CUT})")
        if abs(st["state_bytes"] - sim) > TP_SIM_TOL * sim:
            raise SystemExit(f"tp rank {r}: persistent state "
                             f"{st['state_bytes']} against the traced "
                             f"prediction {sim:.0f}")
        for backend in ("dense", "paged"):
            b = st["batcher"][backend]
            if b["kv"] * TP_NTP != kv1[backend]:
                raise SystemExit(f"tp rank {r} batcher {backend}: KV "
                                 f"{b['kv']} bytes a rank, ntp 1 "
                                 f"{kv1[backend]}")
        bt = st["batcher"]
        log(f"[smoke] tp rank {r} separate (ndp 1, ntp {TP_NTP}): "
            f"{st['seconds'][0] * 1e3:.1f} ms an iteration (init "
            f"{st['init_s']:.1f} s), launches as phase 8 "
            f"{st['launches']}; state {st['state_bytes']} bytes = "
            f"{cut:.4f} of ntp 1's {state} (traced prediction {sim:.0f}, "
            f"{(st['state_bytes'] - sim) / sim:+.2e}); train peak "
            f"{st['train_peak'] / MIB:.0f} MiB; all-reduces/gathers "
            f"{st['counts']}; staged {st['tp_staged_bytes'] / 1e9:.3f} GB "
            f"(model group) + {st['dp_staged_bytes'] / 1e9:.3f} GB (data)")
        log(f"[smoke] tp rank {r} log-prob RMS against fp32: {err:.4e} = "
            f"{st['ratio']:.3f}x ntp 1's {err1:.4e} (at most "
            f"{TP_ERR_RATIO}); with one row all-reduce skipped {fault:.4e} "
            f"= {st['fault_ratio']:.1f}x (must fail)")
        for backend in ("dense", "paged"):
            b = bt[backend]
            log(f"[smoke] tp rank {r} batcher llama3_2_3b {backend} (eager "
                f"decode: a gloo collective cannot be captured): "
                f"{TP_CB_REQUESTS} requests in {b['steps']} steps, "
                f"{b['wall_s']:.2f} s, decode step median "
                f"{b['decode_ms']:.2f} ms; launches {b['launches']}; KV "
                f"{b['kv']} bytes a rank "
                f"({'a token' if backend == 'paged' else 'K and V'}, ntp 1 "
                f"{kv1[backend]}); all-reduces/gathers "
                f"{b['counts']}; staged {b['staged_bytes'] / 1e9:.3f} GB")
        ranks.append(st)
    out.update(ranks=ranks, err1=err1, state_bytes=state, kv1=kv1,
               sim_state=sim, seconds=time.perf_counter() - t_phase)
    log(f"[smoke] tp: phase 16 {out['seconds']:.1f} s (ranks "
        f"{out['ranks_seconds']:.1f} s); nothing across cards measured")
    return out


# --------------------------------------------------------------- phase 17
def serve_launches(cfg, requests: int) -> dict:
    """Kernel launches of ``requests`` serve.run requests of BATCH x
    (PROMPT + GEN) on ``cfg``: per request B2 once an attention layer and
    B5 once a Mamba layer (the prefill), B3 once an attention layer at
    each of the GEN - 1 decode steps, B1 ``step_norms(cfg)`` at the
    prefill and at each step. An MLA layer's prefill is B2 too; its decode
    is plain products (attention in the latent space): no B3."""
    kinds = cfg.layer_kinds()
    attn = sum(k == "attn" for k in kinds)
    want = {k: 0 for k in ops.KERNELS}
    want.update(flash_attention=attention_layers(cfg) * requests,
                decode_attention=attn * (GEN - 1) * requests,
                ssd_scan=sum(k == "mamba" for k in kinds) * requests,
                rmsnorm=step_norms(cfg) * GEN * requests)
    return want


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def family_serving(cfg, dev, log) -> dict:
    """FAM_REQUESTS requests of BATCH x (PROMPT + GEN) through serve.run
    at ``cfg``'s full width (random weights from seed 0): launches as
    :func:`serve_launches` reckons them, outputs checked; each request's
    ms, tok/s and peak above the weights."""
    _free()
    ops.reset_launches()
    t0 = time.perf_counter()
    results = serve.run(cfg, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                        requests=FAM_REQUESTS, temperature=0.8, seed=0,
                        device=dev, log=log)
    _sync(dev)
    secs = time.perf_counter() - t0
    launches, want = dict(ops.launches), serve_launches(cfg, FAM_REQUESTS)
    if launches != want:
        raise SystemExit(f"{cfg.name} serving: launches {launches} != "
                         f"{want}")
    reqs = []
    for r in results:
        check_result(r["result"], BATCH, PROMPT, cfg.vocab_size)
        reqs.append({"seconds": r["seconds"],
                     "tokens_per_s": r["tokens_per_s"],
                     "weights_bytes": r["live_bytes"] or 0,
                     "peak_above_weights": (r["peak_bytes"] or 0)
                     - (r["live_bytes"] or 0)})
    del results
    log(f"[smoke] {cfg.name} ({cfg.num_layers} layers) serving: launches "
        f"{launches} as reckoned; requests " + ", ".join(
            f"{r['seconds'] * 1e3:.1f} ms ({r['tokens_per_s']:.1f} tok/s, "
            f"peak {r['peak_above_weights'] / 2**20:.0f} MiB above the "
            f"weights)" for r in reqs) + f"; weights "
        f"{reqs[0]['weights_bytes'] / 1e9:.2f} GB; {secs:.1f} s in all")
    return {"requests": reqs, "launches": launches, "seconds": secs,
            "num_layers": cfg.num_layers}


def _breakdown_ranges():
    """Wrap the granite decode step's parts in profiler ranges (the MoE
    FFN, its routing and its expert products; the attention mixer) ->
    an undo function."""
    from torch.profiler import record_function

    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TRANSFORMER
    saved = [(MOE, "_route", MOE._route), (MOE, "_experts", MOE._experts),
             (TRANSFORMER.MOE, "moe_fwd", TRANSFORMER.MOE.moe_fwd),
             (TRANSFORMER.L, "attention_decode",
              TRANSFORMER.L.attention_decode)]
    names = {"_route": "moe.route", "_experts": "moe.experts",
             "moe_fwd": "moe", "attention_decode": "attention"}

    def wrap(fn, label):
        def inner(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return inner

    for mod, attr, fn in saved:
        setattr(mod, attr, wrap(fn, names[attr]))

    def undo():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return undo


def granite_step_breakdown(model, params, ids, dev) -> dict:
    """Where an eager granite decode step's device time goes (--profile):
    a prefill, then 16 eager decode steps under torch.profiler with the
    step's parts in ranges: ms a step of the MoE FFN (of which routing:
    router product, top-k sort, the stable sort of the assignments and
    the positions; expert products; the rest: dispatch scatter, combine
    gather and sum), the attention mixer (projections, RoPE, the cache
    write, B3), B1, and all kernels. Kernel time of the eager step, not
    the graphed step's (the same kernels, launched by the graph)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = 16
    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": ids}, PROMPT + GEN)
        tok = torch.argmax(logits, -1)
        pos = torch.full((ids.shape[0],), PROMPT, dtype=torch.int32,
                         device=dev)
        model.decode_step(params, caches, tok, pos)       # warm
        undo = _breakdown_ranges()
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for t in range(n):
                    pos = pos + 1
                    logits, caches = model.decode_step(params, caches, tok,
                                                       pos)
                    tok = torch.argmax(logits, -1)
                torch.cuda.synchronize()
        finally:
            undo()
    del caches
    events = prof.key_averages()
    key = "device_time_total" if hasattr(events[0], "device_time_total") \
        else "cuda_time_total"
    self_key = "self_" + key

    labels = ("moe", "moe.route", "moe.experts", "attention")

    def ms(label):
        return sum(getattr(e, key) for e in events if e.key == label
                   and e.device_type == DeviceType.CPU) / 1e3 / n

    # device events, less the ranges' own device-side annotations
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.key not in labels]
    busy = sum(getattr(e, self_key) for e in kernels) / 1e3 / n
    norms = sum(getattr(e, self_key) for e in kernels
                if "rmsnorm" in e.key) / 1e3 / n
    b3 = sum(getattr(e, self_key) for e in kernels
             if any(f in e.key for f in ("decode_split_kernel",
                                         "combine_kernel"))) / 1e3 / n
    moe, route, experts, attn = (ms(x) for x in labels)
    return {"steps": n, "busy_ms": busy, "moe_ms": moe, "route_ms": route,
            "experts_ms": experts,
            "dispatch_combine_ms": moe - route - experts,
            "attention_ms": attn, "b3_ms": b3, "rmsnorm_ms": norms,
            "rest_ms": busy - moe - attn - norms,
            "top": sorted(((getattr(e, self_key) / n, e.key)
                           for e in kernels), reverse=True)[:12]}


def granite_paths(dev, log, smi, profile=False) -> dict:
    """Phase 17 (b)-(d) on one full-depth granite model (seed 0): a greedy
    request graphed and eager (the same tokens and log-probs bit for bit,
    the same launches and live bytes), one paged GRPO request of phase
    5's shape (launches reckoned, page stats), and a paged batcher drain
    of FAM_CB_REQUESTS mixed requests graphed against eager token for
    token. With ``profile``, also where an eager decode step's time
    goes (:func:`granite_step_breakdown`)."""
    cfg = get_config(GRANITE)
    _free()
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    ids = torch.from_numpy(next(PromptDataset(synthetic_instruction_prompts(
        BATCH, seed=0), PROMPT).batches(BATCH, seed=0)) % cfg.vocab_size
    ).long().to(dev)
    out = {}
    # (b) greedy, graphed against eager
    ro = Rollout(model, cfg, capacity=PROMPT + GEN, temperature=0.0)

    def run(n):
        return ro.generate(params, {"tokens": ids}, n,
                           torch.Generator(device=dev).manual_seed(1))
    calls = {g: _decode_call(ro, run, g, 0.0, GEN) for g in (True, False)}
    (gb, gs, gl, glive, gst), (eb, es, el, elive, _) = calls[True], \
        calls[False]
    want = serve_launches(cfg, 1)
    if not _same_bits(gb, eb):
        raise SystemExit("granite: greedy tokens or log-probs differ "
                         "graphed vs eager")
    if gl != el or gl != want:
        raise SystemExit(f"granite: launches graphed {gl}, eager {el}, "
                         f"reckoned {want}")
    if glive != elive:
        raise SystemExit(f"granite: live bytes after the call {glive} "
                         f"graphed, {elive} eager")
    out["greedy"] = {"graphed_s": gs, "eager_s": es, "launches": gl,
                     "replays": gst["replays"],
                     "capture_ms": gst["capture_ms"],
                     "pool_mib": gst["pool_bytes"] / 2**20}
    log(f"[smoke] granite greedy request [{smi}]: graphed {gs * 1e3:.1f} "
        f"ms, eager {es * 1e3:.1f} ms, the same bits; launches {gl}; "
        f"capture {gst['capture_ms']:.1f} ms, pool "
        f"{gst['pool_bytes'] / 2**20:.1f} MiB, {gst['replays']} replays")
    if profile:
        out["breakdown"] = bd = granite_step_breakdown(model, params, ids,
                                                       dev)
        log(f"[smoke] granite eager decode step [{smi}], device ms a step: "
            f"kernels {bd['busy_ms']:.3f}; MoE FFN {bd['moe_ms']:.3f} "
            f"(routing {bd['route_ms']:.3f}, expert products "
            f"{bd['experts_ms']:.3f}, dispatch and combine "
            f"{bd['dispatch_combine_ms']:.3f}); attention mixer "
            f"{bd['attention_ms']:.3f} (B3 {bd['b3_ms']:.3f}); B1 "
            f"{bd['rmsnorm_ms']:.3f}; the rest (embedding, unembedding, "
            f"residual adds) {bd['rest_ms']:.3f}")
        for us, name in bd["top"]:
            log(f"  {us / 1e3:8.3f} ms a step  {name[:90]}")
    del ro
    _free()

    # (c) one paged GRPO request of phase 5's shape
    gids = torch.from_numpy(next(PromptDataset(synthetic_instruction_prompts(
        GROUPS, seed=0), GPROMPT).batches(GROUPS, seed=0)) % cfg.vocab_size
    ).long().to(dev)
    paged = Rollout(model, cfg, capacity=GPROMPT + GEN, backend="paged",
                    page_size=PAGE, temperature=0.8, top_k=serve.TOP_K)
    L = cfg.num_layers
    want = {k: 0 for k in ops.KERNELS}
    want.update(flash_attention=L, paged_decode_attention=L * (GEN - 1),
                rmsnorm=step_norms(cfg) * GEN + 1)
    ops.reset_launches()
    res, secs, peak = _req(lambda: paged.generate(
        params, {"tokens": gids}, GEN,
        torch.Generator(device=dev).manual_seed(1), group_size=GSIZE))
    made = dict(ops.launches)
    st = paged.page_manager.stats
    if made != want:
        raise SystemExit(f"granite paged GRPO: launches {made} != {want}")
    if st.n_forks != GROUPS * (GSIZE - 1) or st.pages_in_use != 0:
        raise SystemExit(f"granite paged GRPO: page stats {st}")
    check_result(res, GROUPS * GSIZE, GPROMPT, cfg.vocab_size)
    rows = GROUPS * GSIZE
    out["paged_grpo"] = {"seconds": secs, "tokens_per_s": rows * GEN / secs,
                         "peak_above_weights": peak, "launches": made,
                         "cow_copies": st.n_cow_copies, "forks": st.n_forks}
    log(f"[smoke] granite paged GRPO request [{smi}]: {secs * 1e3:.1f} ms "
        f"({rows * GEN / secs:.1f} tok/s), peak {peak / 2**20:.1f} MiB "
        f"above the weights, {st.n_cow_copies} CoW copies; launches {made}")
    del res, paged
    _free()

    # (d) a paged batcher drain, graphed against eager
    traffic = batcher_traffic(cfg.vocab_size, "mixed", seed=0,
                              n=FAM_CB_REQUESTS)
    kw = dict(cache_backend="paged", page_size=CB_PAGE)
    g = serve_batcher(model, cfg, params, kw, traffic, True, dev)
    e = serve_batcher(model, cfg, params, kw, traffic, False, dev)
    for rec in (g, e):
        _check_batcher_run("granite", rec, log)
    _same_run("granite", g, e)
    if not all(st["graphed"] and st["replays"] > 0
               for st in g["graphs"].values()):
        raise SystemExit(f"granite batcher: a graph never replayed: "
                         f"{g['graphs']}")
    tok = sum(len(t) for t in g["tokens"])
    ms_g, ms_e = _step_ms(g), _step_ms(e)
    out["batcher"] = {"tokens": tok, "steps": len(g["steps"]),
                      "graphed_s": g["wall_s"], "eager_s": e["wall_s"],
                      "step_ms": {r: (ms_g[r][0], ms_e.get(r, (None,))[0])
                                  for r in ms_g},
                      "launches": g["launches"], "warm_s": g["warm_s"]}
    log(f"[smoke] granite batcher [{smi}]: {FAM_CB_REQUESTS} requests, "
        f"{tok} tokens in {len(g['steps'])} steps, graphed {g['wall_s']:.3f}"
        f" s ({tok / g['wall_s']:.1f} tok/s), eager {e['wall_s']:.3f} s "
        f"({tok / e['wall_s']:.1f} tok/s), the same tokens; ms a "
        f"decode-only step graphed / eager by rung: " + ", ".join(
            f"{r}: {ms_g[r][0]:.3f} / {ms_e.get(r, (0.0,))[0]:.3f}"
            for r in ms_g) + f"; launches {g['launches']}")
    del model, params, g, e
    _free()
    return out


def granite_separate(dev, log, smi) -> dict:
    """Phase 17 (f): one separate PPO iteration on granite, 8 x (256 +
    256), remat "full", the reward model scoring: the actor and reference
    at full depth, the critic and reward model at GRANITE_CRITIC_LAYERS;
    launches asserted (``ppo_launches``), finite metrics, the persistent
    bytes, per-phase ms and MiB. Running out of memory fails the phase."""
    actor = get_config(GRANITE)
    critic = dataclasses.replace(actor, num_layers=GRANITE_CRITIC_LAYERS)
    rl = RLHFConfig(engine="separate", memory_policy="after_inference",
                    **SEP_KW)
    _free()
    torch.cuda.reset_peak_memory_stats()
    tr, weights, asked = _fresh(lambda: RLHFTrainer(
        actor, critic, rl, torch.Generator(device=dev).manual_seed(0)))
    want = ppo_launches(actor, tr.rl, model_reward=True, critic_cfg=critic)
    secs, m, launches, recs = _run_ppo(
        tr, _sep_prompts(dev, 1, actor.vocab_size),
        torch.Generator(device=dev).manual_seed(7), want,
        "granite separate iteration", 7)
    rows = _phase_rows(recs, weights)
    # the records' peaks (each phase's from its boundary on) above the
    # persistent state
    peak = weights + max(r["peak_mib"] for r in rows) * 2**20
    _print_phases(f"granite separate iteration [{smi}] ({secs * 1e3:.1f} "
                  f"ms; actor and reference {actor.num_layers} layers, "
                  f"critic and reward {critic.num_layers}; persistent "
                  f"{weights / 1e9:.2f} GB, peak {peak / 1e9:.2f} GB)",
                  rows, log)
    log(f"[smoke] granite separate: launches {launches} as reckoned; " +
        ", ".join(f"{k} {v:.4g}" for k, v in sorted(m.items())))
    out = {"seconds": secs, "metrics": m, "launches": launches,
           "phases": rows, "weights_bytes": weights,
           "requested_bytes": asked, "peak_bytes": peak,
           "actor_layers": actor.num_layers,
           "critic_layers": critic.num_layers}
    del tr
    _free()
    return out


def families(dev, log, smi, profile=False) -> dict:
    """Phase 17: qwen1_5_4b (a) and granite_moe_3b_a800m (b) serving at
    full width and depth; granite's greedy graphed-against-eager request,
    paged GRPO request and batcher drain (b-d, :func:`granite_paths`);
    jamba_v0_1_52b serving at one period (e, JAMBA_LAYERS of its 32
    layers); one separate PPO iteration of granite (f); the granite and
    jamba smoke configs on the card against the CPU (g)."""
    t0 = t = time.perf_counter()
    out, parts = {}, {}

    def part(name, fn):
        nonlocal t
        res = fn()
        now = time.perf_counter()
        parts[name], t = now - t, now
        return res

    out["qwen"] = part("qwen", lambda: family_serving(get_config(QWEN), dev,
                                                      log))
    out["granite"] = part("granite", lambda: family_serving(
        get_config(GRANITE), dev, log))
    out["granite"].update(part("granite_paths", lambda: granite_paths(
        dev, log, smi, profile=profile)))
    out["jamba"] = part("jamba", lambda: family_serving(dataclasses.replace(
        get_config(JAMBA), num_layers=JAMBA_LAYERS), dev, log))
    out["granite_separate"] = part("granite_separate",
                                   lambda: granite_separate(dev, log, smi))
    out["small"] = {}
    for name, prompt in ((GRANITE, 40), (JAMBA, 64)):
        out["small"][name] = part(f"small_{name}", lambda: (
            check_small_model_against_cpu(dev, get_config(name).smoke(),
                                          prompt=prompt, seed=5)))
        log(f"[smoke] small {name} model card vs CPU: logits max_err "
            f"{out['small'][name]:.3e}, 16 greedy tokens identical")
    out["seconds"], out["part_seconds"] = time.perf_counter() - t0, parts
    log("[smoke] families: " + ", ".join(f"{k} {v:.1f} s"
                                          for k, v in parts.items()))
    return out


# --------------------------------------------------------------- phase 18
def mla_cache_bytes(cfg) -> tuple:
    """(bytes a token a layer of the MLA decode cache, of a plain cache of
    its heads' K and V), in bf16: the latent and the one rope key, against
    H heads of q/k width nope + rope and of v width v_head_dim."""
    m = cfg.mla
    return (2 * (m.kv_lora_rank + m.qk_rope_head_dim),
            2 * cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim
                                 + m.v_head_dim))


def _ds_prompts(cfg, dev, n):
    data = PromptDataset(synthetic_instruction_prompts(BATCH * n, seed=0),
                         PROMPT).batches(BATCH, seed=0)
    return [torch.from_numpy(next(data) % cfg.vocab_size).long().to(dev)
            for _ in range(n)]


def _greedy_request(ro, params, ids, dev):
    """One greedy generate of ``ids`` -> (result, seconds, peak bytes)."""
    torch.cuda.reset_peak_memory_stats()
    _sync(dev)
    t0 = time.perf_counter()
    res = ro.generate(params, {"tokens": ids}, GEN,
                      torch.Generator(device=dev).manual_seed(1))
    _sync(dev)
    return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def deepseek_serving(dev, log, smi) -> dict:
    """Phase 18 (a): deepseek_v3_671b at full width and DS_SERVE_LAYERS of
    its 61 layers (its 3 dense layers and its first MoE one), with its MTP
    module, random weights from seed 0: FAM_REQUESTS greedy requests of
    BATCH x (PROMPT + GEN), decode graphed; launches as
    :func:`serve_launches` reckons them (B2 once an MLA layer a request,
    no B3 or B4: the latent-space decode is plain products); request 0
    again with the decode loop eager, the same tokens and launches; the
    decode cache's bytes a token against the expanded K and V's."""
    cfg = dataclasses.replace(get_config(DEEPSEEK),
                              num_layers=DS_SERVE_LAYERS)
    _free()
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in leaves(params))
    weights = torch.cuda.memory_allocated()
    ro = Rollout(model, cfg, capacity=PROMPT + GEN, temperature=0.0, top_k=0)
    prompts = _ds_prompts(cfg, dev, FAM_REQUESTS)
    ops.reset_launches()
    reqs, first = [], None
    for ids in prompts:
        res, secs, peak = _greedy_request(ro, params, ids, dev)
        check_result(res, BATCH, PROMPT, cfg.vocab_size)
        if not ro.decode_stats.get("graphed"):
            raise SystemExit("deepseek serving: the decode was not graphed")
        reqs.append({"seconds": secs, "tokens_per_s": BATCH * GEN / secs,
                     "peak_above_weights": peak - weights})
        first = res if first is None else first
    launches, want = dict(ops.launches), serve_launches(cfg, FAM_REQUESTS)
    if launches != want:
        raise SystemExit(f"deepseek serving: launches {launches} != {want}")
    ro._graphs = False
    ops.reset_launches()
    eager, eager_s, _ = _greedy_request(ro, params, prompts[0], dev)
    eager_launches = dict(ops.launches)
    if eager_launches != serve_launches(cfg, 1):
        raise SystemExit(f"deepseek eager request: launches "
                         f"{eager_launches}")
    if not torch.equal(eager.tokens, first.tokens):
        raise SystemExit("deepseek serving: graphed and eager greedy "
                         "tokens differ")
    cache = model.init_cache(1, PROMPT + GEN, torch.bfloat16)
    per_token = sum(t.numel() * t.element_size() for c in cache
                    for name, t in c.items() if name != "pos") // (
                        (PROMPT + GEN) * cfg.num_layers)
    mla, expanded = mla_cache_bytes(cfg)
    if per_token != mla:
        raise SystemExit(f"deepseek cache: {per_token} bytes a token a "
                         f"layer, reckoned {mla}")
    del cache, first, eager
    log(f"[smoke] deepseek_v3_671b serving [{smi}] ({cfg.num_layers} of 61 "
        f"layers + MTP, {n_params / 1e9:.2f}B params, weights "
        f"{weights / 1e9:.2f} GB): launches {launches} as reckoned; greedy "
        f"requests " + ", ".join(
            f"{r['seconds'] * 1e3:.1f} ms ({r['tokens_per_s']:.1f} tok/s, "
            f"peak {r['peak_above_weights'] / 2**20:.0f} MiB above the "
            f"weights)" for r in reqs) + f"; eager request 0 "
        f"{eager_s * 1e3:.1f} ms, the same tokens; decode cache "
        f"{per_token} bytes a token a layer against {expanded} for the "
        f"expanded K and V ({expanded / per_token:.1f}x)")
    out = {"requests": reqs, "launches": launches, "eager_seconds": eager_s,
           "eager_launches": eager_launches, "params": n_params,
           "weights_bytes": weights, "cache_bytes_per_token": per_token,
           "expanded_bytes_per_token": expanded,
           "num_layers": cfg.num_layers}
    del model, params, ro
    _free()
    return out


def deepseek_train(cfg, dev, log, smi, label) -> dict:
    """Phase 18 (b, c): one Adafactor ``make_train_step`` of kind "lm" on
    ``cfg`` at full width, DS_TBATCH x DS_TSEQ tokens, random weights from
    seed 0: launches as :func:`train_launches` reckons them, finite loss
    (and MTP loss), the statistics' bytes those ``Adafactor.state_bytes``
    reckons, the peak against the reckoning (the state, then one bf16
    gradient a parameter, two at several microbatches: the accumulators
    and one microbatch's gradients), a probe of leaves moved."""
    _free()
    model = Model(cfg, device=dev)
    step = TS.make_train_step(model, cfg, kind="lm", lr=1e-4)
    state = TS.init_train_state(
        model, cfg, None, step.optimizer,
        params=model.init(torch.Generator(device=dev).manual_seed(0)))
    params = state["params"]
    n_params = sum(t.numel() for t in leaves(params))
    weights = tree_nbytes(params)
    opt_bytes = tree_nbytes(state["opt"])
    if opt_bytes != step.optimizer.state_bytes(params) - 4:
        raise SystemExit(f"{label}: Adafactor state {opt_bytes} bytes, "
                         f"reckoned {step.optimizer.state_bytes(params) - 4}")
    probes = [(t, t.detach().flatten()[:4096].clone())
              for t in leaves(params) if t.dim() >= 2]
    g = torch.Generator(device=dev).manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (DS_TBATCH, DS_TSEQ), generator=g,
                                     device=dev),
             "loss_mask": torch.ones(DS_TBATCH, DS_TSEQ, device=dev)}
    opt, update = step.optimizer, step.optimizer.update_
    update_s = []

    def timed_update(*a, **kw):      # the optimizer's share of the step
        _sync(dev)
        t = time.perf_counter()
        update(*a, **kw)
        _sync(dev)
        update_s.append(time.perf_counter() - t)

    object.__setattr__(opt, "update_", timed_update)
    _sync(dev)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    _sync(dev)
    secs = time.perf_counter() - t0
    object.__delattr__(opt, "update_")
    peak = torch.cuda.max_memory_allocated()
    launches = dict(ops.launches)
    want = train_launches(cfg, max(1, cfg.microbatches))
    if launches != want:
        raise SystemExit(f"{label}: launches {launches} != {want}")
    metrics = {k: float(v) for k, v in m.items()}
    if not all(math.isfinite(v) for v in metrics.values()) or \
            (cfg.mtp_depth and "mtp_loss" not in metrics):
        raise SystemExit(f"{label}: metrics {metrics}")
    moved = sum(not torch.equal(t.detach().flatten()[:4096], p0)
                for t, p0 in probes)
    if moved < len(probes) // 2:
        raise SystemExit(f"{label}: {moved} of {len(probes)} probed leaves "
                         "moved")
    grads = weights * (1 + (cfg.microbatches > 1))
    reckoned = base + grads
    if not reckoned <= peak <= reckoned + DS_PEAK_SLACK:
        raise SystemExit(f"{label}: peak {peak / 1e9:.2f} GB against the "
                         f"reckoned {reckoned / 1e9:.2f} GB (+ at most "
                         f"{DS_PEAK_SLACK / 2**30:.0f} GiB)")
    log(f"[smoke] {label} [{smi}] ({n_params / 1e9:.2f}B params, "
        f"{weights / 1e9:.2f} GB; {cfg.microbatches} microbatch(es) of "
        f"{DS_TBATCH // cfg.microbatches} x {DS_TSEQ}): {secs * 1e3:.1f} ms "
        f"(Adafactor's update {update_s[0] * 1e3:.1f} ms); "
        f"launches {launches} as reckoned; peak {peak / 1e9:.2f} GB "
        f"against the reckoned {reckoned / 1e9:.2f} GB (state "
        f"{base / 1e9:.2f} + bf16 gradients {grads / 1e9:.2f}); Adafactor "
        f"state {opt_bytes / 1e6:.2f} MB (AdamW's would be "
        f"{8 * n_params / 1e9:.2f} GB); " + ", ".join(
            f"{k} {v:.4g}" for k, v in sorted(metrics.items())))
    out = {"seconds": secs, "update_seconds": update_s[0],
           "launches": launches, "metrics": metrics,
           "params": n_params, "weights_bytes": weights,
           "opt_bytes": opt_bytes, "peak_bytes": peak,
           "reckoned_bytes": reckoned, "microbatches": cfg.microbatches,
           "moved": moved, "probes": len(probes)}
    del model, step, state, params, probes
    _free()
    return out


def check_small_mla_against_cpu(dev, seed=5, tol=1e-4) -> dict:
    """deepseek's smoke config at MLA's own head widths (q/k 192, v 128;
    the smoke's 48 / 32 are no pair the kernels take), f32: the card
    through the kernels (B2 and B2-bwd on their fp32 routes) against the
    CPU through the plain versions: prefill logits within 1e-4, 16
    greedy tokens identical, and two Adafactor train steps from the same
    weights to the same metrics within ``tol`` (the second step's read the
    first step's update; as ``check_small_ppo_against_cpu`` holds PPO:
    Adafactor's first update is ~lr times the sign of each gradient
    element, so an element summed to ~0 in another order may move either
    way, and params are not held element by element)."""
    from repro_torch.configs import MLAConfig
    cfg = dataclasses.replace(
        get_config(DEEPSEEK).smoke(), optimizer="adafactor",
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128))
    err = check_small_model_against_cpu(dev, cfg, prompt=40, seed=seed)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(seed))
    params0 = Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed))
    out = []
    for device in ("cpu", dev):
        model = Model(cfg, device=device)
        step = TS.make_train_step(model, cfg, kind="lm", lr=1e-3)
        state = TS.init_train_state(model, cfg, None, step.optimizer,
                                    params=_to(params0, device))
        batch = {"tokens": tokens.to(device),
                 "loss_mask": torch.ones(2, 32, device=device)}
        out.append([{k: float(v) for k, v in step(state, batch)[1].items()}
                    for _ in range(2)])
    train_err = max(abs(a[k] - b[k]) for a, b in zip(*out) for k in a)
    if not train_err <= tol:
        raise SystemExit(f"small MLA train steps card vs CPU: metrics "
                         f"differ by {train_err}: {out}")
    return {"logits_err": err, "train_err": train_err,
            "metrics": out[1]}


def deepseek(dev, log, smi) -> dict:
    """Phase 18: deepseek_v3_671b (MLA layers, a dense leading segment,
    256-expert MoE, MTP, Adafactor) at full width: (a) serving at
    DS_SERVE_LAYERS of its layers (:func:`deepseek_serving`); (b) one
    Adafactor train step with the trunk cut to its first dense layer, its
    MTP module (the reference's MTP layer is its last segment's kind:
    here MLA with a dense FFN) and the MTP loss, at 2 microbatches (bf16
    accumulation); (c) one on one MoE layer (MLA, 256 routed experts and
    the shared one), at one microbatch, Adafactor's update block by block
    over its 3.76 G-element expert leaves; (d) a small MLA model on the
    card against the CPU."""
    t0 = t = time.perf_counter()
    parts, out = {}, {}

    def part(name, fn):
        nonlocal t
        res = fn()
        now = time.perf_counter()
        parts[name], t = now - t, now
        return res

    ds = get_config(DEEPSEEK)
    out["serve"] = part("serve", lambda: deepseek_serving(dev, log, smi))
    out["train_dense_mtp"] = part("train_dense_mtp", lambda: deepseek_train(
        dataclasses.replace(ds, num_layers=1, first_k_dense=1,
                            microbatches=2), dev, log, smi,
        "deepseek train step, one dense layer + MTP"))
    out["train_moe"] = part("train_moe", lambda: deepseek_train(
        dataclasses.replace(ds, num_layers=1, first_k_dense=0, mtp_depth=0,
                            microbatches=1), dev, log, smi,
        "deepseek train step, one MoE layer"))
    out["small"] = part("small", lambda: check_small_mla_against_cpu(dev))
    log(f"[smoke] small MLA model card vs CPU: logits max_err "
        f"{out['small']['logits_err']:.3e}, 16 greedy tokens identical; two "
        f"Adafactor steps' metrics within {out['small']['train_err']:.3e}")
    out["seconds"], out["part_seconds"] = time.perf_counter() - t0, parts
    log("[smoke] deepseek: " + ", ".join(f"{k} {v:.1f} s"
                                          for k, v in parts.items()))
    return out

# --------------------------------------------------------------- phase 19
def big_paths(cfg, dev, log, smi, label, batcher=False) -> dict:
    """Phase 19 (a, b) on one model of ``cfg`` (random weights from seed
    0): FAM_REQUESTS greedy requests of BATCH x (PROMPT + GEN), the decode
    graphed, launches as :func:`serve_launches` reckons them; request 0
    again with the decode loop eager, the same tokens and launches; one
    paged GRPO request of phase 5's shape (GROUPS prompts of GPROMPT
    tokens forked GSIZE ways, GEN new), launches reckoned and page stats;
    with ``batcher``, a dense and a paged drain of BIG_CB_REQUESTS mixed
    requests (8 slots over CB_CAP), each graphed against eager token for
    token, launches as :func:`batcher_launches` reckons them."""
    _free()
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in leaves(params))
    weights = tree_nbytes(params)
    graphs = dev.type == "cuda"       # nothing is captured on the CPU
    ro = Rollout(model, cfg, capacity=PROMPT + GEN, temperature=0.0, top_k=0)
    prompts = _ds_prompts(cfg, dev, FAM_REQUESTS)
    out = {"params": n_params, "weights_bytes": weights,
           "num_layers": cfg.num_layers}

    def greedy(ids):
        return _req(lambda: ro.generate(
            params, {"tokens": ids}, GEN,
            torch.Generator(device=dev).manual_seed(1)), dev)
    ops.reset_launches()
    reqs, first = [], None
    for ids in prompts:
        res, secs, peak = greedy(ids)
        check_result(res, BATCH, PROMPT, cfg.vocab_size)
        if ro.decode_stats.get("graphed") != graphs:
            raise SystemExit(f"{label} serving: decode graphed "
                             f"{ro.decode_stats.get('graphed')}")
        reqs.append({"seconds": secs, "tokens_per_s": BATCH * GEN / secs,
                     "peak_above_weights": peak})
        first = res if first is None else first
    launches, want = dict(ops.launches), serve_launches(cfg, FAM_REQUESTS)
    if launches != want:
        raise SystemExit(f"{label} serving: launches {launches} != {want}")
    ro._graphs = False
    ops.reset_launches()
    eager, eager_s, _ = greedy(prompts[0])
    eager_launches = dict(ops.launches)
    if eager_launches != serve_launches(cfg, 1):
        raise SystemExit(f"{label} eager request: launches {eager_launches}")
    if not (torch.equal(eager.tokens, first.tokens) and
            torch.equal(eager.logp, first.logp)):
        raise SystemExit(f"{label} serving: graphed and eager greedy "
                         "tokens or log-probs differ")
    out.update(requests=reqs, launches=launches, eager_seconds=eager_s,
               eager_launches=eager_launches)
    log(f"[smoke] {label} serving [{smi}] ({cfg.num_layers} layers, "
        f"{n_params / 1e9:.2f}B params, weights {weights / 1e9:.2f} GB): "
        f"launches {launches} as reckoned; greedy requests " + ", ".join(
            f"{r['seconds'] * 1e3:.1f} ms ({r['tokens_per_s']:.1f} tok/s, "
            f"peak {r['peak_above_weights'] / 2**20:.0f} MiB above the "
            f"weights)" for r in reqs) + f"; eager request 0 "
        f"{eager_s * 1e3:.1f} ms, the same tokens and log-probs")
    del ro, first, eager

    # one paged GRPO request of phase 5's shape
    gids = torch.from_numpy(next(PromptDataset(synthetic_instruction_prompts(
        GROUPS, seed=0), GPROMPT).batches(GROUPS, seed=0)) % cfg.vocab_size
    ).long().to(dev)
    paged = Rollout(model, cfg, capacity=GPROMPT + GEN, backend="paged",
                    page_size=PAGE, temperature=0.8, top_k=serve.TOP_K)
    L = cfg.num_layers
    want = {k: 0 for k in ops.KERNELS}
    want.update(flash_attention=L, paged_decode_attention=L * (GEN - 1),
                rmsnorm=step_norms(cfg) * GEN + 1)
    ops.reset_launches()
    res, secs, peak = _req(lambda: paged.generate(
        params, {"tokens": gids}, GEN,
        torch.Generator(device=dev).manual_seed(1), group_size=GSIZE), dev)
    made = dict(ops.launches)
    st = paged.page_manager.stats
    if made != want:
        raise SystemExit(f"{label} paged GRPO: launches {made} != {want}")
    if st.n_forks != GROUPS * (GSIZE - 1) or st.pages_in_use != 0:
        raise SystemExit(f"{label} paged GRPO: page stats {st}")
    check_result(res, GROUPS * GSIZE, GPROMPT, cfg.vocab_size)
    rows = GROUPS * GSIZE
    out["paged_grpo"] = {"seconds": secs, "tokens_per_s": rows * GEN / secs,
                         "peak_above_weights": peak, "launches": made,
                         "cow_copies": st.n_cow_copies, "forks": st.n_forks}
    log(f"[smoke] {label} paged GRPO request [{smi}]: {secs * 1e3:.1f} ms "
        f"({rows * GEN / secs:.1f} tok/s), peak {peak / 2**20:.1f} MiB "
        f"above the weights, {st.n_cow_copies} CoW copies; launches {made}")
    del res, paged
    _free()

    if batcher:
        traffic = batcher_traffic(cfg.vocab_size, "mixed", seed=0,
                                  n=BIG_CB_REQUESTS)
        out["batcher"] = {}
        for kind, kw in (("dense", dict(cache_backend="dense")),
                         ("paged", dict(cache_backend="paged",
                                        page_size=CB_PAGE))):
            name = f"{label} {kind} batcher"
            g = serve_batcher(model, cfg, params, kw, traffic, True, dev)
            e = serve_batcher(model, cfg, params, kw, traffic, False, dev)
            for rec in (g, e):
                _check_batcher_run(name, rec, log)
            _same_run(name, g, e)
            if graphs and not all(st["graphed"] and st["replays"] > 0
                                  for st in g["graphs"].values()):
                raise SystemExit(f"{name}: a graph never replayed: "
                                 f"{g['graphs']}")
            tok = sum(len(t) for t in g["tokens"])
            ms_g, ms_e = _step_ms(g), _step_ms(e)
            out["batcher"][kind] = {
                "tokens": tok, "steps": len(g["steps"]),
                "graphed_s": g["wall_s"], "eager_s": e["wall_s"],
                "step_ms": {r: (ms_g[r][0], ms_e.get(r, (None,))[0])
                            for r in ms_g},
                "launches": g["launches"], "warm_s": g["warm_s"],
                "peak_above": g["peak_above"]}
            log(f"[smoke] {name} [{smi}]: {BIG_CB_REQUESTS} requests, "
                f"{tok} tokens in {len(g['steps'])} steps, graphed "
                f"{g['wall_s']:.3f} s ({tok / g['wall_s']:.1f} tok/s), eager "
                f"{e['wall_s']:.3f} s ({tok / e['wall_s']:.1f} tok/s), the "
                f"same tokens; ms a decode-only step graphed / eager by "
                f"rung: " + ", ".join(
                    f"{r}: {ms_g[r][0]:.3f} / "
                    f"{ms_e.get(r, (0.0,))[0]:.3f}" for r in ms_g) +
                f"; launches {g['launches']}")
            del g, e
            _free()
    del model, params
    _free()
    return out


def big_train(cfg, dev, log, smi, label, steps: int = 2) -> dict:
    """Phase 19 (c): ``steps`` ``make_train_step`` steps of kind "lm" on
    ``cfg`` at full width with its own optimizer (adamw_bf16: bf16
    moments) and microbatches (2), BIG_TBATCH x BIG_TSEQ tokens, random
    weights from seed 0: each step's launches as :func:`train_launches`
    reckons them, finite metrics, the optimizer's bytes those
    ``AdamW.state_bytes`` reckons (against the fp32 moments ``adamw``
    would hold), the peak against the reckoning (params and moments, then
    two bf16 gradient sets: the accumulators and one microbatch's; with
    tied embeddings two more of the embedding's, its lookup's and its
    head's gradients before autograd sums them), each step's ms and the
    update's (the first step's include first-call costs), a probe of
    leaves moved by the first step."""
    _free()
    model = Model(cfg, device=dev)
    step = TS.make_train_step(model, cfg, kind="lm", lr=1e-4)
    if step.optimizer.moment_dtype != "bfloat16" or cfg.microbatches != 2:
        raise SystemExit(f"{label}: optimizer {step.optimizer}, "
                         f"{cfg.microbatches} microbatches")
    state = TS.init_train_state(
        model, cfg, None, step.optimizer,
        params=model.init(torch.Generator(device=dev).manual_seed(0)))
    params = state["params"]
    n_params = sum(t.numel() for t in leaves(params))
    weights = tree_nbytes(params)
    opt_bytes = tree_nbytes(state["opt"])
    if opt_bytes != step.optimizer.state_bytes(params) - 4 or \
            opt_bytes != 4 * n_params:
        raise SystemExit(f"{label}: optimizer state {opt_bytes} bytes, "
                         f"reckoned {step.optimizer.state_bytes(params) - 4}")
    fp32_bytes = make_optimizer("adamw").state_bytes(params) - 4
    probes = [(t, t.detach().flatten()[:4096].clone())
              for t in leaves(params) if t.dim() >= 2]
    g = torch.Generator(device=dev).manual_seed(3)
    # a fresh batch a step: one adamw step on a batch (each element moved
    # by ~lr) takes a random model at full width to ~0 loss on that batch
    batches = [{"tokens": torch.randint(0, cfg.vocab_size,
                                        (BIG_TBATCH, BIG_TSEQ), generator=g,
                                        device=dev),
                "loss_mask": torch.ones(BIG_TBATCH, BIG_TSEQ, device=dev)}
               for _ in range(steps)]
    opt, update = step.optimizer, step.optimizer.update_
    update_s = []

    def timed_update(*a, **kw):      # the optimizer's share of the step
        _sync(dev)
        t = time.perf_counter()
        update(*a, **kw)
        _sync(dev)
        update_s.append(time.perf_counter() - t)

    object.__setattr__(opt, "update_", timed_update)
    base = _alloc(dev)
    want = train_launches(cfg, cfg.microbatches)
    secs, peak, metrics, moved = [], 0, [], None
    for batch in batches:
        ops.reset_launches()
        (state, m), sec, pk = _req(lambda: step(state, batch), dev)
        launches = dict(ops.launches)
        if launches != want:
            raise SystemExit(f"{label}: launches {launches} != {want}")
        secs.append(sec)
        peak = max(peak, base + pk)
        metrics.append({k: float(v) for k, v in m.items()})
        if not all(math.isfinite(v) for v in metrics[-1].values()):
            raise SystemExit(f"{label}: metrics {metrics[-1]}")
        if moved is None:
            moved = sum(not torch.equal(t.detach().flatten()[:4096], p0)
                        for t, p0 in probes)
    object.__delattr__(opt, "update_")
    if moved < len(probes) // 2:
        raise SystemExit(f"{label}: {moved} of {len(probes)} probed leaves "
                         "moved")
    # the bf16 accumulators and one microbatch's gradients (the params'
    # dtype, bf16 on the card); a tied embedding's lookup and head each
    # give a gradient of the whole leaf, which autograd then sums into a
    # third
    grads = n_params * TS.acc_dtype(cfg).itemsize + weights
    tied = 2 * tree_nbytes(params["embed"]) if cfg.tie_embeddings else 0
    reckoned = base + grads + tied
    if dev.type == "cuda" and \
            not reckoned - tied <= peak <= reckoned + DS_PEAK_SLACK:
        raise SystemExit(f"{label}: peak {peak / 1e9:.2f} GB against the "
                         f"reckoned {reckoned / 1e9:.2f} GB (+ at most "
                         f"{DS_PEAK_SLACK / 2**30:.0f} GiB)")
    free = torch.cuda.mem_get_info(dev)[1] - peak if dev.type == "cuda" \
        else 0
    log(f"[smoke] {label} [{smi}] ({cfg.num_layers} layers, "
        f"{n_params / 1e9:.2f}B params, {weights / 1e9:.2f} GB; "
        f"{cfg.microbatches} microbatches of "
        f"{BIG_TBATCH // cfg.microbatches} x {BIG_TSEQ}): steps " +
        ", ".join(f"{a * 1e3:.1f} ms (the adamw_bf16 update {b * 1e3:.1f} "
                  f"ms)" for a, b in zip(secs, update_s)) +
        f"; launches {want} a step as reckoned; peak {peak / 1e9:.2f} GB "
        f"against the reckoned {reckoned / 1e9:.2f} GB (params "
        f"{weights / 1e9:.2f} + bf16 moments {opt_bytes / 1e9:.2f} + two "
        f"bf16 gradient sets {grads / 1e9:.2f}" +
        (f" + the tied embedding's two gradients {tied / 1e9:.2f}"
         if tied else "") + f"), {free / 1e9:.2f} GB of the card left; "
        f"optimizer state {opt_bytes / 1e9:.2f} GB against "
        f"{fp32_bytes / 1e9:.2f} GB of fp32 moments (adamw); {moved} of "
        f"{len(probes)} probed leaves moved; " + "; ".join(", ".join(
            f"{k} {v:.4g}" for k, v in sorted(mt.items()))
            for mt in metrics))
    out = {"seconds": secs, "update_seconds": update_s,
           "launches": want, "metrics": metrics, "params": n_params,
           "weights_bytes": weights, "opt_bytes": opt_bytes,
           "tied_grad_bytes": tied,
           "fp32_opt_bytes": fp32_bytes, "peak_bytes": peak,
           "reckoned_bytes": reckoned, "free_bytes": free,
           "microbatches": cfg.microbatches, "num_layers": cfg.num_layers,
           "moved": moved, "probes": len(probes)}
    del model, step, state, params, probes, batches
    _free()
    return out


def blocked_update_bits(dev, log, smi, shape=BIG_FFN_LEAF) -> dict:
    """AdamW (fp32 moments) on one fp32 leaf of ``shape`` (qwen1_5_110b's
    FFN leaf, 403M elements) two steps, block by block (``BLOCK_ELEMS``
    elements a block) against one whole-leaf block: the params and both
    moments the same bits; each update's ms and peak above what was
    live."""
    _free()
    g = torch.Generator(device=dev).manual_seed(7)
    p = torch.randn(shape, generator=g, device=dev)
    block = ADAMW.BLOCK_ELEMS
    if p.numel() <= block:
        raise SystemExit(f"blocked update: {p.numel()} elements is one block")
    opt, runs = AdamW(), {}
    for name, elems in (("blocked", block), ("whole", p.numel())):
        pp = p.clone()
        st = opt.init([pp])
        gg = torch.Generator(device=dev).manual_seed(8)
        times, peaks = [], []
        for _ in range(2):
            grad = 1e-3 * torch.randn(shape, generator=gg, device=dev)
            ADAMW.BLOCK_ELEMS = elems
            try:
                _, secs, peak = _req(lambda: opt.update_(
                    [grad], st, [pp], 1e-4), dev)
            finally:
                ADAMW.BLOCK_ELEMS = block
            times.append(secs)
            peaks.append(peak)
            del grad
        runs[name] = (pp, st, times, peaks)
    (pb, sb, tb, kb), (pw, sw, tw, kw) = runs["blocked"], runs["whole"]
    same = torch.equal(pb, pw) and torch.equal(sb["mu"][0], sw["mu"][0]) \
        and torch.equal(sb["nu"][0], sw["nu"][0])
    if not same:
        raise SystemExit("blocked AdamW update differs from the whole-leaf "
                         "one")
    n_blocks = -(-shape[0] // max(1, block // shape[1]))
    log(f"[smoke] AdamW on a {shape[0]} x {shape[1]} fp32 leaf "
        f"({p.numel() / 1e6:.0f}M elements) [{smi}]: {n_blocks} blocks the "
        f"same bits as one whole-leaf block after 2 steps; ms a step "
        f"blocked {tb[1] * 1e3:.1f}, whole {tw[1] * 1e3:.1f}; peak above "
        f"the state blocked {kb[1] / 1e9:.2f} GB, whole {kw[1] / 1e9:.2f} GB")
    out = {"elements": p.numel(), "blocks": n_blocks, "same_bits": same,
           "blocked_ms": tb[1] * 1e3, "whole_ms": tw[1] * 1e3,
           "blocked_peak_bytes": kb[1], "whole_peak_bytes": kw[1]}
    del runs, pb, sb, pw, sw, p
    _free()
    return out


def g12_smoke_cfg():
    """command_r_plus_104b's smoke config at its G 12 (12 query heads over
    one KV head, head_dim 64), f32, the optimizer adamw_bf16."""
    return dataclasses.replace(get_config(CMDR).smoke(), num_heads=12,
                               num_kv_heads=1, optimizer="adamw_bf16")


def big_dense(dev, log, smi) -> dict:
    """Phase 19: qwen1_5_110b (G 8, qkv bias, untied) and
    command_r_plus_104b (G 12, tied) at full width with adamw_bf16: (a)
    qwen's serving and paged GRPO request at BIG_SERVE_LAYERS layers
    (:func:`big_paths`, through B2, B1, B3 and B4 at G 8); (b)
    command-r's, through B3 and B4 at G 12, with its dense and paged
    batcher drains graphed against eager; (c) one adamw_bf16 train step of
    each at BIG_TRAIN_LAYERS layers (:func:`big_train`); (d) the blocked
    AdamW update of qwen's FFN leaf against the whole-leaf one, bit for
    bit; (e) the G 12 smoke model on the card against the CPU."""
    t0 = t = time.perf_counter()
    parts, out = {}, {}

    def part(name, fn):
        nonlocal t
        res = fn()
        now = time.perf_counter()
        parts[name], t = now - t, now
        return res

    for m in BIG:
        cfg = dataclasses.replace(get_config(BIG[m]),
                                  num_layers=BIG_SERVE_LAYERS[m])
        out[m] = part(m, lambda: big_paths(cfg, dev, log, smi, BIG[m],
                                           batcher=m == "cmdr"))
    for m in BIG:
        cfg = dataclasses.replace(get_config(BIG[m]),
                                  num_layers=BIG_TRAIN_LAYERS[m])
        out[f"{m}_train"] = part(f"{m}_train", lambda: big_train(
            cfg, dev, log, smi, f"{BIG[m]} adamw_bf16 train step"))
    out["blocked"] = part("blocked", lambda: blocked_update_bits(dev, log,
                                                                 smi))
    out["small"] = part("small", lambda: check_small_model_against_cpu(
        dev, g12_smoke_cfg(), prompt=40, seed=5))
    log(f"[smoke] small G 12 model ({CMDR}'s smoke config, 12 query heads "
        f"over 1 KV head) card vs CPU: logits max_err {out['small']:.3e}, "
        f"16 greedy tokens identical")
    out["seconds"], out["part_seconds"] = time.perf_counter() - t0, parts
    log("[smoke] big dense: " + ", ".join(f"{k} {v:.1f} s"
                                           for k, v in parts.items()))
    return out


# --------------------------------------------------------------- phase 20
def emb_inputs(cfg, rows: int, g, dev, dtype=None) -> dict:
    """``cfg``'s embeddings for ``rows`` prompts, EMB_SCALE x a normal draw
    from ``g`` in ``dtype`` (the params' by default): ``prefix_embeds``
    [rows, num_prefix_embeddings, d] before the tokens, or an
    encoder-decoder's ``frame_embeds`` [rows, num_prefix_embeddings, d]."""
    key = {"embeddings": "prefix_embeds", "encdec": "frame_embeds"}
    dtype = dtype or {"bfloat16": torch.bfloat16,
                      "float32": torch.float32}[cfg.param_dtype]
    x = torch.randn(rows, cfg.num_prefix_embeddings, cfg.d_model,
                    generator=g, device=dev)
    return {key[cfg.input_mode]: (EMB_SCALE * x).to(dtype)}


def emb_serve_launches(cfg, requests: int) -> dict:
    """Kernel launches of ``requests`` dense rollout calls of BATCH x
    (PROMPT + GEN) on ``cfg``: :func:`serve_launches` (the prefill's B2 and
    each decode step's B3 at every self-attention layer, B1 at norm1, norm2
    and the final norm of the prefill and each step), and on an
    encoder-decoder the encoder once a call (B2 non-causal and B1 at its
    two norms a layer, then ``encoder_norm``) and each decoder layer's
    cross-attention: B2 non-causal over the frames at the prefill (S
    queries) and at each decode step (one), B1 at its ``norm_x`` in the
    prefill and in each step."""
    want = serve_launches(cfg, requests)
    if cfg.input_mode == "encdec":
        L, E = cfg.num_layers, cfg.encoder_layers
        want["flash_attention"] += (E + L * GEN) * requests
        want["rmsnorm"] += (2 * E + 1 + L * GEN) * requests
    return want


def emb_train_launches(cfg) -> dict:
    """Kernel launches of one ``make_train_step`` step (one microbatch,
    remat "full") on ``cfg``: :func:`train_launches`, and on an
    encoder-decoder the encoder (each layer a checkpoint: B2 forward and
    again in the backward, B2-bwd; B1 at its two norms, again in the
    backward, then ``encoder_norm`` once, and B1-bwd at all 2E + 1: every
    scale trains) and each decoder layer's cross-attention inside its
    layer's checkpoint (B2 twice and B2-bwd once, B1 at ``norm_x`` twice
    and B1-bwd once)."""
    want = train_launches(cfg, 1)
    if cfg.input_mode == "encdec":
        L, E = cfg.num_layers, cfg.encoder_layers
        remat = cfg.remat != "none"
        want["flash_attention"] += (E + L) * (1 + remat)
        want["flash_attention_bwd"] += E + L
        want["rmsnorm"] += 2 * E + 1 + remat * 2 * E + L * (1 + remat)
        want["rmsnorm_bwd"] += 2 * E + 1 + L
    return want


def cross_kv_bytes(cfg, rows: int) -> int:
    """The cross K/V an encoder-decoder's prefill keeps for its decode
    steps: a K and a V [rows, frames, K, hd] a decoder layer, in the
    params' dtype."""
    itemsize = 2 if cfg.param_dtype == "bfloat16" else 4
    return cfg.num_layers * 2 * rows * cfg.num_prefix_embeddings * \
        cfg.num_kv_heads * cfg.resolved_head_dim() * itemsize


def emb_paths(cfg, dev, log, smi, label) -> dict:
    """Phase 20 (a): FAM_REQUESTS greedy dense rollout calls of BATCH x
    (PROMPT + GEN) on ``cfg`` at full width and depth (random weights from
    seed 0) with its embeddings in the batch (:func:`emb_inputs`), the
    decode graphed, launches as :func:`emb_serve_launches` reckons them;
    request 0 again with the decode loop eager, the same tokens, log-probs
    and launches. Each request's ms, tok/s, peak above the weights and the
    live bytes after it (its result dropped) against those before it (after
    one uncounted short call, which leaves the capture stream's cuBLAS
    workspace, where no earlier phase has); an
    encoder-decoder's cross K/V bytes against :func:`cross_kv_bytes`."""
    _free()
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in leaves(params))
    weights = tree_nbytes(params)
    graphs = dev.type == "cuda"       # nothing is captured on the CPU
    P0 = TS._prefix_len(cfg)
    ro = Rollout(model, cfg, capacity=P0 + PROMPT + GEN, temperature=0.0,
                 top_k=0)
    g = torch.Generator(device=dev).manual_seed(2)
    prompts = [dict(tokens=ids, **emb_inputs(cfg, BATCH, g, dev))
               for ids in _ds_prompts(cfg, dev, FAM_REQUESTS)]
    cross = []
    prefill = model.prefill

    def spy(*a, **kw):
        out = prefill(*a, **kw)
        cross.append(tree_nbytes(out[1]["cross_kv"] or []))
        return out
    model.prefill = spy
    out = {"params": n_params, "weights_bytes": weights,
           "num_layers": cfg.num_layers,
           "encoder_layers": cfg.encoder_layers, "prefix": P0}

    def greedy(batch):
        before = _alloc(dev)
        res, secs, peak = _req(lambda: ro.generate(
            params, batch, GEN, torch.Generator(device=dev).manual_seed(1)),
            dev)
        check_result(res, BATCH, PROMPT, cfg.vocab_size)
        bits = (res.tokens.cpu(), res.logp.cpu())
        del res
        _sync(dev)
        return bits, secs, peak, before, _alloc(dev)
    # one call of two decode steps first, uncounted: a first capture on
    # the capture stream sets up its cuBLAS workspace, which stays
    ro.generate(params, prompts[0], 3, torch.Generator(device=dev))
    _sync(dev)
    ops.reset_launches()
    reqs, first = [], None
    for batch in prompts:
        bits, secs, peak, before, after = greedy(batch)
        if ro.decode_stats.get("graphed") != graphs:
            raise SystemExit(f"{label}: decode graphed "
                             f"{ro.decode_stats.get('graphed')}")
        if after != before:
            raise SystemExit(f"{label}: live bytes {after} after a request, "
                             f"{before} before it")
        reqs.append({"seconds": secs, "tokens_per_s": BATCH * GEN / secs,
                     "peak_above_weights": peak, "live_before": before,
                     "live_after": after})
        first = bits if first is None else first
    launches, want = dict(ops.launches), emb_serve_launches(cfg, FAM_REQUESTS)
    if launches != want:
        raise SystemExit(f"{label}: launches {launches} != {want}")
    want_cross = cross_kv_bytes(cfg, BATCH) if cfg.input_mode == "encdec" \
        else 0
    if any(c != want_cross for c in cross):
        raise SystemExit(f"{label}: cross K/V {cross} bytes, reckoned "
                         f"{want_cross}")
    ro._graphs = False
    ops.reset_launches()
    eager, eager_s, _, _, _ = greedy(prompts[0])
    eager_launches = dict(ops.launches)
    if eager_launches != emb_serve_launches(cfg, 1):
        raise SystemExit(f"{label} eager request: launches {eager_launches}")
    if not (torch.equal(eager[0], first[0]) and
            torch.equal(eager[1], first[1])):
        raise SystemExit(f"{label}: graphed and eager greedy tokens or "
                         "log-probs differ")
    out.update(requests=reqs, launches=launches, eager_seconds=eager_s,
               eager_launches=eager_launches, cross_kv_bytes=want_cross)
    log(f"[smoke] {label} dense rollout [{smi}] ({cfg.num_layers} decoder "
        f"layers" + (f", {cfg.encoder_layers} encoder layers over "
                     f"{cfg.num_prefix_embeddings} frames"
                     if cfg.encoder_layers else
                     f", {P0} prefix embeddings") +
        f", {n_params / 1e9:.3f}B params, weights {weights / 1e9:.2f} GB): "
        f"launches {launches} as reckoned; greedy requests " + ", ".join(
            f"{r['seconds'] * 1e3:.1f} ms ({r['tokens_per_s']:.1f} tok/s, "
            f"peak {r['peak_above_weights'] / 2**20:.0f} MiB above the "
            f"weights, live after = before {r['live_after'] / 2**20:.1f} "
            f"MiB)" for r in reqs) +
        (f"; cross K/V {want_cross / 1e6:.1f} MB a request as reckoned"
         if want_cross else "") + f"; eager request 0 {eager_s * 1e3:.1f} "
        f"ms, the same tokens and log-probs")
    del ro, model.prefill, prompts
    del model, params
    _free()
    return out


def emb_train(cfg, dev, log, smi, label, steps: int = 2) -> dict:
    """Phase 20 (b): ``steps`` ``make_train_step`` steps of kind "ppo" on
    ``cfg`` at full width and depth (remat "full", AdamW: bf16 params,
    fp32 gradients and moments), EMB_TBATCH x PROMPT tokens with the
    config's embeddings, random weights from seed 0: each step's launches
    as :func:`emb_train_launches` reckons them, finite metrics, each
    step's ms, a probe of leaves moved by the first step (the encoder's
    included), the peak against the reckoning (params, moments, the fp32
    accumulators and one set of bf16 gradients, plus at most
    DS_PEAK_SLACK of activations and logits)."""
    _free()
    model = Model(cfg, device=dev)
    step = TS.make_train_step(model, cfg, kind="ppo", lr=1e-4)
    state = TS.init_train_state(
        model, cfg, None, step.optimizer,
        params=model.init(torch.Generator(device=dev).manual_seed(0)))
    params = state["params"]
    n_params = sum(t.numel() for t in leaves(params))
    weights = tree_nbytes(params)
    opt_bytes = tree_nbytes(state["opt"])
    probes = [(t, t.detach().flatten()[:4096].clone())
              for t in leaves(params) if t.dim() >= 2]
    enc = {id(t) for t in leaves(params.get("encoder") or [])
           if t.dim() >= 2}
    g = torch.Generator(device=dev).manual_seed(3)
    V, R = cfg.vocab_size, EMB_TBATCH
    batches = []
    for _ in range(steps):
        b = {"tokens": torch.randint(0, V, (R, PROMPT), generator=g,
                                     device=dev),
             "loss_mask": torch.ones(R, PROMPT, device=dev),
             "advantages": torch.randn(R, PROMPT, generator=g, device=dev),
             "old_logp": torch.full((R, PROMPT), -math.log(V), device=dev),
             "ref_logp": torch.full((R, PROMPT), -math.log(V), device=dev),
             "returns": torch.zeros(R, PROMPT, device=dev)}
        b.update(emb_inputs(cfg, R, g, dev))
        batches.append(b)
    base = _alloc(dev)
    want = emb_train_launches(cfg)
    secs, peak, metrics, moved, moved_enc = [], 0, [], None, None
    for batch in batches:
        ops.reset_launches()
        (state, m), sec, pk = _req(lambda: step(state, batch), dev)
        launches = dict(ops.launches)
        if launches != want:
            raise SystemExit(f"{label}: launches {launches} != {want}")
        secs.append(sec)
        peak = max(peak, base + pk)
        metrics.append({k: float(v) for k, v in m.items()})
        if not all(math.isfinite(v) for v in metrics[-1].values()):
            raise SystemExit(f"{label}: metrics {metrics[-1]}")
        if moved is None:
            flags = [(id(t) in enc, not torch.equal(
                t.detach().flatten()[:4096], p0)) for t, p0 in probes]
            moved = sum(f for _, f in flags)
            moved_enc = sum(f for e, f in flags if e)
    if moved < len(probes) // 2 or (enc and moved_enc < len(enc) // 4):
        raise SystemExit(f"{label}: {moved} of {len(probes)} probed leaves "
                         f"moved ({moved_enc} of the encoder's)")
    # the fp32 accumulators and one backward's gradients in the params'
    # dtype (bf16), beside params and fp32 moments; above them the
    # activations and the loss's fp32 work on the logits [R, P + S, V]
    grads = n_params * TS.acc_dtype(cfg).itemsize + weights
    reckoned = base + grads
    logits32 = R * (TS._prefix_len(cfg) + PROMPT) * V * 4
    slack = DS_PEAK_SLACK + 4 * logits32
    if dev.type == "cuda" and not reckoned <= peak <= reckoned + slack:
        raise SystemExit(f"{label}: peak {peak / 1e9:.2f} GB against the "
                         f"reckoned {reckoned / 1e9:.2f} GB (+ at most "
                         f"{slack / 1e9:.2f} GB: four fp32 logits of "
                         f"{logits32 / 1e9:.2f} GB and "
                         f"{DS_PEAK_SLACK / 2**30:.0f} GiB)")
    P0 = TS._prefix_len(cfg)
    log(f"[smoke] {label} [{smi}] ({cfg.num_layers} decoder layers" +
        (f", {cfg.encoder_layers} encoder layers" if cfg.encoder_layers
         else "") + f", {n_params / 1e9:.3f}B params; {R} x ("
        + (f"{P0} + " if P0 else "") + f"{PROMPT})" +
        (f" over {cfg.num_prefix_embeddings} frames" if cfg.encoder_layers
         else "") + ", remat full): steps " +
        ", ".join(f"{a * 1e3:.1f} ms" for a in secs) +
        f"; launches {want} a step as reckoned; peak {peak / 1e9:.2f} GB "
        f"against the reckoned {reckoned / 1e9:.2f} GB (bf16 params "
        f"{weights / 1e9:.2f} + fp32 moments {opt_bytes / 1e9:.2f} + fp32 "
        f"accumulators and bf16 gradients {grads / 1e9:.2f}; fp32 logits "
        f"{logits32 / 1e9:.2f}); {moved} of "
        f"{len(probes)} probed leaves moved" +
        (f" ({moved_enc} of the encoder's {len(enc)})" if enc else "") +
        "; " + "; ".join(", ".join(f"{k} {v:.4g}" for k, v in
                                   sorted(mt.items())) for mt in metrics))
    out = {"seconds": secs, "launches": want, "metrics": metrics,
           "params": n_params, "weights_bytes": weights,
           "opt_bytes": opt_bytes, "peak_bytes": peak,
           "reckoned_bytes": reckoned, "logits_fp32_bytes": logits32,
           "moved": moved,
           "moved_encoder": moved_enc, "probes": len(probes)}
    del model, step, state, params, probes, batches
    _free()
    return out


def embeddings(dev, log, smi) -> dict:
    """Phase 20: internvl2_2b (256 prefix embeddings) and
    seamless_m4t_large_v2 (a 24-layer encoder over 1024 frames, cross-
    attention in its 24 decoder layers) at full width and depth: (a) each
    one's dense rollout requests, graphed and eager (:func:`emb_paths`);
    (b) two ppo train steps of each (:func:`emb_train`); (c) each smoke
    config (2 decoder layers, d_model 256, 4 heads of 64; seamless's 2
    encoder layers over 8 frames, internvl's 8 prefix embeddings; f32) on
    the card against the CPU."""
    t0 = t = time.perf_counter()
    parts, out = {}, {}

    def part(name, fn):
        nonlocal t
        res = fn()
        now = time.perf_counter()
        parts[name], t = now - t, now
        return res

    for m, name in EMB.items():
        cfg = get_config(name)
        out[m] = part(m, lambda: emb_paths(cfg, dev, log, smi, name))
        out[f"{m}_train"] = part(f"{m}_train", lambda: emb_train(
            cfg, dev, log, smi, f"{name} ppo train step"))
        out[f"{m}_small"] = part(f"{m}_small", lambda: (
            check_small_model_against_cpu(dev, cfg.smoke(), prompt=24,
                                          seed=7)))
        log(f"[smoke] small {name} ({cfg.smoke().name}) card vs "
            f"CPU: logits max_err {out[f'{m}_small']:.3e}, 16 greedy tokens "
            f"identical")
    out["seconds"], out["part_seconds"] = time.perf_counter() - t0, parts
    log("[smoke] embeddings: " + ", ".join(f"{k} {v:.1f} s"
                                           for k, v in parts.items()))
    return out


def port_kernels(rows):
    """{wrapper: {"ms", "calls", "us_per_call", "us_per_call_by_kernel"}}
    from profiler rows (us, count, name): each wrapper's kernels' device
    time in the profiled run, in all and per kernel function, per call of
    the wrapper."""
    out = {}
    for wrapper, funcs in KERNEL_FUNCS.items():
        calls = sum(r[1] for r in rows if any(f in r[2] for f in funcs))
        if not calls:
            continue
        split = {f: sum(r[0] for r in rows if f in r[2])
                 for f in funcs + SECOND_KERNELS.get(wrapper, ())}
        us = sum(split.values())
        out[wrapper] = {"ms": us / 1e3, "calls": calls,
                        "us_per_call": us / calls,
                        "us_per_call_by_kernel": {
                            f: t / calls for f, t in split.items() if t}}
    return out


def profile_call(fn):
    """Kernel time by name over one call of ``fn`` (torch.profiler; kernel
    events only, so the device's busy time is the sum of its kernels),
    its wall time (host clock, synchronised) and the device's idle share
    of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    key = "self_device_time_total" if hasattr(events[0],
                                               "self_device_time_total") \
        else "self_cuda_time_total"
    rows = sorted(((getattr(e, key), e.count, e.key) for e in events
                   if e.device_type == DeviceType.CUDA and getattr(e, key) > 0),
                  reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    table = events.table(sort_by=key, row_limit=40)
    return {"profiled_wall_s": wall, "kernel_busy_s": busy_s,
            "idle_share": 1 - busy_s / wall, "port": port_kernels(rows),
            "top": [{"us": r[0], "count": r[1], "name": r[2]}
                    for r in rows[:15]]}, table


def print_profile(label, prof):
    print(f"[smoke] profiled {label}: wall "
          f"{prof['profiled_wall_s'] * 1e3:.1f} ms, kernels busy "
          f"{prof['kernel_busy_s'] * 1e3:.1f} ms, idle share "
          f"{prof['idle_share']:.3f}")
    for wrapper, k in prof["port"].items():
        by = k["us_per_call_by_kernel"]
        print(f"  port {wrapper:22s} {k['ms']:9.3f} ms {k['calls']:6d} calls "
              f"{k['us_per_call']:9.2f} us a call" + (" (" + ", ".join(
                  f"{f} {t:.2f}" for f, t in by.items()) + ")"
                  if len(by) > 1 else ""))
    for row in prof["top"][:10]:
        print(f"  {row['us'] / 1e3:9.3f} ms {row['count']:6d}x "
              f"{row['name'][:90]}")


# ------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also profile one dense, one paged GRPO and one "
                         "Mamba2 request and one hydra and one separate "
                         "PPO iteration with torch.profiler, and one "
                         "serving request graphed and eager")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)
    report = {"phase_seconds": {}}
    t_start = t_last = time.perf_counter()

    def lap(phase):
        """Print and keep the wall time of the phase just ended."""
        nonlocal t_last
        now = time.perf_counter()
        report["phase_seconds"][phase] = now - t_last
        print(f"[smoke] phase {phase}: {now - t_last:.1f} s (at "
              f"{now - t_start:.1f} s)", flush=True)
        t_last = now

    # phase 1: card, versions, build
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"])
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    print(f"[smoke] card: {smi}")
    print(f"[smoke] host memory: {meminfo()}")
    print(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"triton {triton_v} (unused); peaks {peaks}")
    path, log, secs = build.build()
    print(f"[smoke] built {path.relative_to(ROOT)} in {secs:.1f} s")
    if not log:           # built before: the ptxas lines are in the log
        log = (path.parent / "ptxas.txt").read_text()
    (OUT_DIR / "ptxas.txt").write_text(log)
    report.update(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
                  build_s=secs, sass=check_build(path, log))

    lap(1)
    # phase 2: kernels against their plain versions
    g = torch.Generator(device=dev).manual_seed(0)
    checks = {"flash_attention": check_flash(dev, peaks, g),
              "decode_attention": check_decode(dev, peaks, g),
              "paged_decode_attention": check_paged(dev, peaks, g),
              "rmsnorm": check_rmsnorm(dev, peaks, g),
              "ssd_scan": check_ssd(dev, peaks, g),
              "flash_attention_bwd": check_flash_bwd(dev, peaks, g),
              "rmsnorm_bwd": check_rmsnorm_bwd(dev, peaks, g)}
    failures = []
    for kname, recs in checks.items():
        for r in recs:
            line = (f"[smoke] {kname:16s} {r['case']:13s} max_err "
                    f"{r['max_err']:.3e} (tol {r['tol']:g})")
            if "lse_err" in r:
                line += f" [out {r['out_err']:.3e}, lse {r['lse_err']:.3e}]"
            if "dscale_cold_ms" in r:
                line += (f"  with dscale: warm "
                         f"{r['dscale_device_ms'] * 1e3:.2f} us, cold "
                         f"{r['dscale_cold_ms'] * 1e3:.2f} us")
            if "ms" in r:
                lib = "none" if r["library_ms"] is None else \
                    f"{r['library_ms']:.4f} ms"
                line += (f"  kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f}"
                         f" ms  library {lib}  bound "
                         f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})")
                if "yardstick_ms" in r:
                    line += f"  gather+SDPA {r['yardstick_ms']:.4f} ms"
            if "cold_ms" in r:
                line += (f"  graph: warm {r['device_ms'] * 1e3:.2f} us, "
                         f"cold {r['cold_ms'] * 1e3:.2f} us")
                if r.get("library_cold_ms") is not None:
                    if "library_device_ms" in r:
                        line += (f"; library warm "
                                 f"{r['library_device_ms'] * 1e3:.2f} us")
                    line += (f", library cold "
                             f"{r['library_cold_ms'] * 1e3:.2f} us")
                if "bound_ms" in r and "ms" not in r:
                    line += (f"  bound {r['bound_ms'] * 1e3:.2f} us "
                             f"({r['bound_by']})")
            if "unique_pages" in r:
                line += (f"; {r['unique_pages']} distinct pages "
                         f"{r['unique_mib']:.1f} MiB, per row "
                         f"{r['per_row_mib']:.1f} MiB")
            if "plan" in r:
                pl = r["plan"]
                line += (f"; plan {pl['tiles']} tiles x {pl['splits']} "
                         f"splits of {pl['span']} pages, copies "
                         f"{r['page_loads']} pages a head (a block: max "
                         f"{r['block_loads_max']}, mean "
                         f"{r['block_loads_mean']:.1f})")
            print(line)
            if not r["max_err"] <= r["tol"]:
                failures.append(f"{kname}/{r['case']}: {r['max_err']}")
    report["checks"] = checks
    if failures:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{failures}")

    lap(2)
    # phase 3: the serving path at full width and depth
    cfg = get_config("llama3_2_3b")
    torch.cuda.synchronize()
    ops.reset_launches()
    results = serve.run(cfg, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                        requests=REQUESTS, temperature=0.8, seed=0,
                        device=dev, log=lambda s: print(s, flush=True))
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    L = cfg.num_layers
    want = {"flash_attention": L * REQUESTS,
            "decode_attention": L * (GEN - 1) * REQUESTS,
            "paged_decode_attention": 0, "ssd_scan": 0,
            "rmsnorm": (2 * L + 1) * GEN * REQUESTS,
            "flash_attention_bwd": 0, "rmsnorm_bwd": 0}
    print(f"[smoke] launches {launches} (want {want})")
    if launches != want:
        raise SystemExit(f"launch counts {launches} != {want}")
    report["requests"] = [{k: v for k, v in r.items() if k != "result"}
                          for r in results]

    lap(3)
    # phase 4: outputs
    check_outputs(results, cfg.vocab_size)
    small_err = check_small_model_against_cpu(dev)
    print(f"[smoke] outputs ok; small GQA model card vs CPU: logits "
          f"max_err {small_err:.3e}, 16 greedy tokens identical")
    report["small_model_max_err"] = small_err

    lap(4)
    # phase 5: the paged GRPO rollout at full width and depth
    grpo = paged_grpo(cfg, dev, lambda s: print(s, flush=True),
                      profile=args.profile)
    print(f"[smoke] paged GRPO launches {grpo['launches']} over "
          f"{GREQUESTS} requests; forks {grpo['requests'][0]['forks']}")
    report["paged_grpo"] = grpo

    lap(5)
    # phase 6: Mamba2 serving at full width and depth
    mamba = mamba_serving(dev, lambda s: print(s, flush=True),
                          profile=args.profile)
    report["mamba"] = mamba

    lap(6)
    # phase 7: hydra PPO iterations at full width and depth
    ppo = ppo_iterations(dev, lambda s: print(s, flush=True),
                         profile=args.profile)
    report["ppo"] = ppo

    lap(7)
    # phase 8: the paper's four-model PPO at full width and depth
    sep = separate_ppo(dev, lambda s: print(s, flush=True),
                       profile=args.profile)
    report["ppo_separate"] = sep

    lap(8)
    # phase 9: host offload on both engines at full width and depth
    off = offload_ppo(dev, lambda s: print(s, flush=True))
    report["offload"] = off
    lap(9)
    # phase 10: every decode path graphed against eager in this call
    report["decode_graphs"] = decode_graphs(
        dev, lambda s: print(s, flush=True), profile=args.profile)
    lap(10)
    # phase 11: the paper's memory study on the card, and GRPO
    report["memory_study"] = memory_study(
        dev, lambda s: print(s, flush=True), sep, off)
    lap(11)
    # phase 12: runtime telemetry on phase 8's pair, and a caught OOM
    report["telemetry"] = telemetry_ppo(
        dev, lambda s: print(s, flush=True),
        plain=[r["metrics"] for r in sep["iterations"]],
        profile=args.profile)
    lap(12)
    # phase 13: MTP self-speculative decoding
    report["spec"] = spec_decoding(dev, lambda s: print(s, flush=True),
                                   profile=args.profile)
    lap(13)
    # phase 14: the continuous batcher, graphed against eager
    report["batcher"] = continuous_batching(dev,
                                            lambda s: print(s, flush=True))
    lap(14)
    # phase 15: ZeRO over NCCL at ndp 1 and over gloo at ndp 2 on one card
    report["zero"] = zero_ppo(
        dev, lambda s: print(s, flush=True),
        hydra_plain=([r["metrics"] for r in ppo["iterations"]],
                     ppo["trained"]),
        sep_plain=([r["metrics"] for r in sep["iterations"]],
                   sep["trained"]))

    lap(15)
    # phase 16: Megatron TP over gloo, two ranks sharing the card
    report["tp"] = tp_ppo(dev, lambda s: print(s, flush=True))
    lap(16)
    # phase 17: three more families at full width: MoE, hybrid, dense MHA
    report["families"] = fam = families(dev, lambda s: print(s, flush=True),
                                        smi, profile=args.profile)
    lap(17)
    # phase 18: deepseek_v3_671b's MLA, MoE and Adafactor at full width
    report["deepseek"] = ds = deepseek(dev, lambda s: print(s, flush=True),
                                       smi)
    lap(18)
    # phase 19: qwen1_5_110b and command_r_plus_104b (G 12) at full width
    report["big_dense"] = big = big_dense(
        dev, lambda s: print(s, flush=True), smi)
    lap(19)
    # phase 20: prefix embeddings (internvl2_2b) and an encoder-decoder
    # (seamless_m4t_large_v2) at full width and depth
    report["embeddings"] = emb = embeddings(
        dev, lambda s: print(s, flush=True), smi)
    lap(20)
    paths = {"serve": launches, "paged_grpo": grpo["launches"],
             "mamba_serve": mamba["launches"], "ppo": ppo["launches"],
             "ppo_separate": sep["launches"],
             "ppo_separate_offload": off["launches"],
             "ppo_offload": off["hydra_launches"],
             "ppo_telemetry": report["telemetry"]["launches"],
             "spec_serve": report["spec"]["serve"]["dense"]["launches"],
             "spec_paged": report["spec"]["serve"]["paged"]["launches"],
             "ppo_spec": report["spec"]["ppo"]["launches"]}
    paths.update({f"batcher_{name}": report["batcher"][name]["launches"]
                  for name in (*CB_RUNS, *CB_SPEC_RUNS)})
    paths.update({f"zero_{key}": run["launches"]
                  for key, run in report["zero"]["nccl"].items()})
    paths.update({f"zero_gloo_{key}": run["ranks"][0]["launches"]
                  for key, run in report["zero"]["gloo"].items()
                  if key != "ndp1"})
    paths["tp_separate"] = report["tp"]["ranks"][0]["launches"]
    paths.update({"qwen_serve": fam["qwen"]["launches"],
                  "granite_serve": fam["granite"]["launches"],
                  "granite_greedy": fam["granite"]["greedy"]["launches"],
                  "granite_paged_grpo":
                      fam["granite"]["paged_grpo"]["launches"],
                  "granite_batcher": fam["granite"]["batcher"]["launches"],
                  "jamba_serve": fam["jamba"]["launches"],
                  "granite_separate":
                      fam["granite_separate"]["launches"]})
    paths.update({f"tp_batcher_{b}": report["tp"]["ranks"][0]["batcher"][b][
        "launches"] for b in ("dense", "paged")})
    paths.update({"deepseek_serve": ds["serve"]["launches"],
                  "deepseek_train_dense_mtp":
                      ds["train_dense_mtp"]["launches"],
                  "deepseek_train_moe": ds["train_moe"]["launches"]})
    for m in BIG:
        paths.update({f"{m}_serve": big[m]["launches"],
                      f"{m}_paged_grpo": big[m]["paged_grpo"]["launches"],
                      f"{m}_train": big[f"{m}_train"]["launches"]})
    paths.update({f"cmdr_batcher_{kind}": run["launches"]
                  for kind, run in big["cmdr"]["batcher"].items()})
    for m in EMB:
        paths.update({f"{m}_serve": emb[m]["launches"],
                      f"{m}_train": emb[f"{m}_train"]["launches"]})

    if args.profile:
        prof, table = profile_request(cfg, dev)
        (OUT_DIR / "profile.txt").write_text(table)
        print(f"[smoke] unprofiled: prefill {prof['prefill_ms']:.1f} ms, "
              f"decode {prof['decode_step_ms']:.2f} ms/step (greedy)")
        print_profile("request", prof)
        report["profile"] = prof
        print_profile("paged GRPO request", grpo["profile"])
        (OUT_DIR / "profile_paged.txt").write_text(grpo.pop("profile_table"))
        print_profile("mamba2 request", mamba["profile"])
        (OUT_DIR / "profile_mamba.txt").write_text(mamba.pop("profile_table"))
        print_profile("ppo iteration", ppo["profile"])
        (OUT_DIR / "profile_ppo.txt").write_text(ppo.pop("profile_table"))
        print_profile("separate ppo iteration", sep["profile"])
        (OUT_DIR / "profile_separate.txt").write_text(
            sep.pop("profile_table"))

    kernels = []
    main_path = {"paged_decode_attention": "paged_grpo",
                 "ssd_scan": "mamba_serve", "flash_attention_bwd": "ppo",
                 "rmsnorm_bwd": "ppo"}
    for kname, source, replaces in (
            ("flash_attention", fa.SOURCE, fa.REPLACES),
            ("decode_attention", dec.SOURCE, dec.REPLACES),
            ("paged_decode_attention", pa.SOURCE, pa.REPLACES),
            ("rmsnorm", rn.SOURCE, rn.REPLACES),
            ("ssd_scan", ssd.SOURCE, ssd.REPLACES),
            ("flash_attention_bwd", fab.SOURCE, fab.REPLACES),
            ("rmsnorm_bwd", rn.SOURCE, rn.REPLACES_BWD)):
        main_rec = checks[kname][0]
        path = main_path.get(kname, "serve")
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": paths[path][kname],
            "path": path,
            "launches_by_path": {p: c[kname] for p, c in paths.items()},
            "max_abs_err": max(r.get("max_abs_err", r["max_err"])
                               for r in checks[kname]),
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
            "device_ms": main_rec.get("device_ms"),
            "cold_ms": main_rec.get("cold_ms"),
            "library_cold_ms": main_rec.get("library_cold_ms"),
            "library_device_ms": main_rec.get("library_device_ms"),
            "yardstick_ms": main_rec.get("yardstick_ms"),
            "max_err": max(r["max_err"] for r in checks[kname]),
            "kernel_ms": main_rec["ms"],
            "bound_us": main_rec["bound_ms"] * 1e3,
        })
    report["kernels"] = kernels
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
