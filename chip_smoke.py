#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

and the phases that several cards change, on four cards (the kernels
on every card; a mesh rank or a tp shard a card, over NCCL):

    python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.main(
        phases=('env', 'kernels', 'tp', 'mesh'), cards=4))"

Phases, each printing one JSON line; any failure exits non-zero:

1. **env**     torch / CUDA versions, the card, and the build of every
               hand-written kernel from ``src/repro_torch/csrc``.
2. **kernels** each kernel against its plain PyTorch version on the
               card at qwen3-0.6b FULL attention shapes (H 16, KVH 8,
               Dh 128, page 16), bf16, with kernel / plain / library /
               bound times, and the kernel's own bitwise properties
               (a row's bits depend on its own keys only; 32-row chunks
               of the 512-token prefill at offsets 0, 32, 224 and 480
               give the whole prefill's bits; the contiguous decode
               gives the paged decode's bits).  Paged attention also at
               ~2,000-key contexts and at Dh 64 with two row groups,
               with the key-split grid's block counts.  Then both
               kernels at the attention shapes of the other served
               architectures (``ATTN_SHAPES``: G 7 and G 1 at Dh 64, G 5
               and G 8 at Dh 128, and the families' G 1 and G 7 at
               Dh 128): paged at B 8 with T 1 and T 5, flash on a
               512-token prefill, with the same properties.  Then the
               families' new cases: flash with a 2,048-key window at Dh
               256 (recurrentgemma), flash without a causal mask over
               whisper's 1,500 frames (encoder and cross-attention),
               paged at Dh 256 over a 2,048-key ring, and flash at one
               query row as the families' decode steps run it
               (``components.flash_decode_attention``: deepseek,
               qwen2-vl and whisper over a longer cache, recurrentgemma
               over its wrapped ring, whisper's cross-attention), each
               row also against the plain version over the linear
               history and bit for bit against the same row of the
               whole prefill.  Then the training path's kernels: the
               attention backward (``flash_attention_bwd``) at qwen3's
               training shape (B 8 x S 256), B 1 x S 2,048, a ragged
               S 200, Dh 64 without a causal mask, and the families'
               training shapes (recurrentgemma's 2,048-key window at Dh
               256 and G 10 over 4,096 tokens, whisper's cross-attention
               64 x 1,500 and encoder, qwen2-vl's G 7), against its
               plain version (dq, dk, dv), with the forward's lse
               against the plain forward's, two calls bit for bit equal,
               and SDPA's backward under the same mask as the library
               time; and the projections' backward products on the
               dataflow GEMM (dX = dY W^T, dW = X^T dY at qwen3's
               ``attn/wq``, ``ffn/wd``, ``ffn/wg``, 2,048 rows) beside
               cuBLAS, and those of the weights that enter in f32 (the
               deepseek router, RG-LRU's ``wr``, RWKV6's decay LoRA) at
               the train_families phase's rows.  Beside each backward time
               (``ms``, CUDA events, L2 flushed) its ``device_ms``: the
               kernels' own time from a profiler trace of back-to-back
               calls.  Where more than one card is visible, every
               kernel once more on each card in turn, in this one
               process, against its plain version (``_every_card``: a
               kernel's attributes belong to each card's context).
3. **paper**   the paper's kernel path at full width: the dataflow GEMM
               (all four reuse schemes) on llama4-scout's expert
               up-projection (M 8192, K 5120, N 8192, bf16), input-/
               weight-stationary again at 2M / 2N (twice the blocks),
               and a ragged f32 GEMM (all four dataflows, bit-identical:
               the f32 output-stationary kernel is gemm_f32.cuh, the
               others the FMA tile of tile_mma.cuh), the block-sparse
               GEMM on the same
               operands at the Table-3 keep rates, and the LUT
               activation on the GEMM's output shape and on all eight
               tables.  Its entry points run once with the launch
               counters at 0 (the path); then each kernel is held
               against its plain version (the four dataflows bit-
               identical, dead columns exactly 0, the LUT bit-identical,
               its scalar tail and unaligned paths too, the bf16
               pipeline's TMA and cp.async producers bit-identical) and
               timed beside its plain version, a library call and its
               bound; the LUT once more with every x equal (no gather
               spread).  Then the dataflow GEMM as the serving path runs
               it (``components.linear``) at the projection shapes of
               qwen3's ``attn/wq`` and ``ffn/wd`` and scout's
               ``mix/wk`` at 8, 40, 256 and 2,048 rows, with the
               producer each took and whether a row's bits depend on the
               row count; then the products whose weight enters in f32
               (``F32_SHAPES``: the MoE routers, RG-LRU's gate, RWKV6's
               decay LoRA) at the row counts of the card's paths, gated
               on NO_REUSE's bits and on row stability, with the plan
               (``plan_f32``) and kernel / torch.matmul device times.
4. **serve**   qwen3-0.6b at full width (seeded random init) serves 16
               synthetic requests through ``ServeEngine`` and the
               kernels' launch counters prove the path ran through them;
               then the engine's bitwise invariants at the model level,
               gated (``_bitwise_invariants``: chunked == whole prefill,
               verify at T = 1 == decode, fused == unfused) on 8 prompts
               of mixed lengths, and every product of layer 0 and the
               unembedding row-stable (``_row_bits``, gated).  The
               engine replays its programs as CUDA graphs
               (``serve/compiled.py``); the same trace eagerly
               (``ServePrograms(model, graphs=False)``) is a reading
               beside it, and on the step clock a gate
               (``_graph_gate``): streams, dispatch counters, both
               pools and the kernels' launches equal, and one dispatch
               of each program's logits read from a graph's static
               output after a replay (``_graph_logits``), all
               ``torch.equal``.
5. **parity**  every served token is re-scored teacher-forced by the
               port's whole-sequence ``apply`` on the card, and held
               token for token against the port's ``greedy_generate``
               (engine == oracle, gated), whose decode step replays a
               CUDA graph (``ServePrograms.lockstep``, ``pos`` a device
               scalar); gated against the same oracle run eagerly
               (``_oracle_graph_gate``): the tokens equal, and one
               step's logits and cache after a replay
               (``_lockstep_logits``), ``torch.equal``.
6. **profile** a shorter serve run under ``torch.profiler``: device
               time by kernel and the device's idle share, on the
               graphed programs and then eagerly, the graphed engine
               twice (the second run replays every graph).  After the
               fleet a ``graphs`` line: the graphs held and captured by
               program, the capture seconds and the replays, the extra
               peak memory, and tok/s, mean TTFT and idle share graphed
               and eager.
7. **fleet**   the serving fleet on the serve phase's model and program
               bundle, one line per sub-run: (a) two replicas behind
               the prefix-affinity router (beside one engine on the same
               trace, and profiled), (b) replicas joining, draining and
               crashing mid-trace on a synthetic step clock (migration
               and journal recovery), (c) the streaming front-end over an
               elastic fleet with two weighted tenants, (d) an engine
               drafting with a second full-width model, whose decode
               replays a CUDA graph a slot, held against the same trace
               with a drafter decoding eagerly (every proposal, the
               drafted count, the accept rate and the streams equal)
               and one draft decode's logits after a replay.  Each is
               held to the parity phase's re-score, its event streams,
               the allocator invariants, the dispatch identity and the
               kernels' launch counts.
8. **archs**   the other architectures the port serves, one line each,
               after the qwen3 model and fleet are freed: qwen2-0.5b and
               stablelm-1.6b at full size, llama4-scout at full widths
               cut to 4 of its 48 layers at capacity factor 16 (C = T),
               each with seeded random weights through the serve phase's
               trace, the parity phase's re-score and engine == oracle,
               the launch gates, the bitwise invariants and the row-bits
               gate; for scout also whether layer 0's routed experts on
               the first chunk equal an f32 recomputation of its router,
               and the serve phase's graph == eager gate (the MoE and
               its cuBLAS experts inside the graphs).
9. **tp**      tensor-parallel serving (``TP_RUNS``): qwen3-0.6b at tp 2
               and 4, qwen2-0.5b and stablelm-1.6b at tp 2, full size,
               seeded random weights, placed by ``device_plan``: a card
               a shard where there are tp cards (``TPServePrograms(
               model, tp=tp)``), else every shard named ``cuda:0``
               (``devices=[...]``); heads, KV heads and d_ff split, the
               pools on KV heads; on TP_REQUESTS requests of the serve phase's
               prompt and generation lengths through TP_BATCH slots (so
               slots and pages turn over) on the step clock beside
               the same engine at tp 1, every engine replaying CUDA
               graphs (tp-way: in pieces cut at the gathers,
               ``parallel.PiecewiseProgram``); gated on more admissions
               than slots, every stream equal to tp 1's, the dispatch
               counters equal, each shard's pools equal to tp 1's head
               slices (``torch.equal``, the null page aside) at 1 / tp
               of the bytes, each path kernel launched exactly tp times
               tp 1's count, one dispatch each of chunk, decode, verify
               at T 5 and fused giving every shard tp 1's logits
               (``torch.equal``), the engine replaying its graphs, and
               one dispatch of each program through the pieces, replayed
               on other inputs, equal to the eager ``TPServePrograms``
               (logits and every shard's pools, ``_tp_graph_logits``).
               Served tok/s, the graphs' captures, replays and pieces,
               and each card's peak are readings (co-located shards
               time-share the card).
10. **families** the five families the reference serves only through
               its lockstep path, one after the other at full published
               widths (seeded random weights, projections stored bf16 as
               they are drawn): deepseek-moe-16b, qwen2-vl-7b,
               whisper-tiny, recurrentgemma-2b and rwkv6-3b (every
               layer, but rwkv6's 4 of 32, ``FAMILY_LAYERS``), each
               through the ``--naive`` loop (``launch.serve.run_naive``) on 8
               prompts of the reference's synthetic batch, its decode
               step replaying one CUDA graph (``pos`` a device scalar),
               gated on every row finishing, the TAU re-score, decode
               extending prefill, the row-bits gate, the kernels'
               launch counts, and the loop graphed == eager (the tokens
               of the same loop run eagerly, one step's logits and
               cache after a replay: ``_lockstep_logits``;
               recurrentgemma's steps all past its ring's wrap); each
               row's tokens against the same prompt alone
               through ``greedy_generate`` are a reading, and so, for
               recurrentgemma and rwkv6, is the gap between the prompt
               forms of their recurrences (the associative RG-LRU scan,
               the chunked and the step-by-step WKV) and the decode
               step's, in f32 and in bf16 (``_scan_forms``).
               These families do not page: their decode steps run the
               flash kernel at one query row, which gives decode the
               bits of the whole prefill's row.
11. **train**  qwen3-0.6b at full width (28 layers) trains through the
               launcher (``launch.train.main``: B 8 x S 256, 10 steps,
               a checkpoint every 5), gated on finite positive losses
               and gradient norms, no restart, the checkpoints of steps
               5 and 10 and the launch counts (per step: flash forward
               2 L, its backward L, the dataflow GEMM 4 x the
               projections); the same 10 steps through ``TrainDriver``
               with a fault injected at step 7 must restore step 5 and
               end equal (``torch.equal``) to the launcher's step-10
               checkpoint; at 2 of 28 layers every leaf gets a non-zero
               gradient, within 5e-2 relative L2 of the CPU's plain path
               (loss within 2e-2); and 8 steps on one fixed batch must
               lower the loss, the last 2 under ``torch.profiler``
               (device time by kernel group, idle share); then 5 steps
               with the parameters stored f32 and 5 stored bf16
               (``param_dtype="bfloat16"``, AdamW ``keep_master``):
               step ms and peak GB of each, every loss finite.
12. **train_families** the MoE and the lockstep-only families train at
               full widths (``FAMILY_TRAIN``; depth cut to fit the card
               with AdamW, seeded random init): whisper-tiny (also
               through the launcher), deepseek-moe-16b (3 of 28
               layers), qwen2-vl-7b (3 of 28), recurrentgemma-2b (6 of
               26, S 4,096 over its 2,048-key window) and rwkv6-3b (16
               of 32), each gated on a loss that falls over 8 steps on
               one batch, two first steps from one state equal
               (``torch.equal``), the launches a step (flash forward 2,
               backward 1 an attention layer; the GEMM 4 a projection,
               f32 ones counted apart), and at a cut depth (one block
               pattern; recurrentgemma's over S 1,024 with its window
               cut to 512, so that the window masks; whisper one
               encoder and one decoder layer) the card against the
               CPU's plain path (loss within 2e-2, every leaf within
               5e-2 relative L2, no leaf that the CPU gives a gradient
               without one on the card; the MoE's CPU run
               takes the card's expert ids and reports how many tokens
               its own router sent elsewhere), with step ms, tokens/s
               and the peak memory.  llama4-scout trains on the CPU
               only (its one layer with Adam needs ~77 GB).
13. **dryrun** the dry run (``launch/dryrun.py``) anchored on the card:
               qwen3-0.6b FULL traced on ``meta`` for one train step (B 8
               x S 256) and one decode step (B 8, cache 256 + 32), then
               the same steps run on the card after a warm one: each
               kernel's predicted launches equal its counter, the
               predicted argument bytes equal the real tensors', and
               the traced peak is within DRYRUN_PEAK_TOL of
               ``max_memory_allocated``; the production cells
               qwen3-0.6b and qwen1.5-110b ``train_4k`` on rank 0 of
               (16, 16), traced on the CPU in subprocesses started
               before the families phase, are read (per-device GB,
               fits, bottleneck, model fraction; gated: model FLOPs a
               device exactly 6 N_active tokens / 256, and the traced
               FLOPs a device and the dataflow GEMM's share at or below
               DRYRUN_FLOPS + 1 %, which a rank projecting every KV
               head, not only those its query heads read, exceeds);
               llama4-scout-17b-a16e and rwkv6-3b ``train_4k`` the same,
               rwkv6 at 4 of its 32 layers (``model`` = 16 does not
               divide their 40 heads: rank 0 computes 3, and a rank
               running the whole attention exceeds the gate about
               3- to 4-fold).
14. **mesh**   the training mesh (``launch/mesh.py``, ``sharding/``):
               ranks as processes (``torch.multiprocessing``), placed by
               ``device_plan``: a card a rank over NCCL where there are
               enough cards, else every one on this card over gloo
               (NCCL refuses two ranks on one device); the kernels
               built before the spawn.  qwen3-0.6b
               FULL on (data 2, model 2): the first step's loss and
               every leaf's gradient against the single-device step run
               here (loss within 2e-2, each leaf within 5e-2 relative
               L2), each rank's launches equal to it, 2 steps timed;
               deepseek-moe-16b at full widths, 2 layers, on (1, 4) (16
               of 64 experts a rank): the final hidden states at C = T
               (routed as the single device routed) within 2e-2
               relative L2, at its own capacity factor more than 98 %
               within 3e-2, and the gradients as above; qwen3's prefill
               of 8 x 256 and 8 decode steps on (1, 4) with the cache
               split along its sequence, each step's logits within 2e-2
               relative L2; a checkpoint saved on (2, 2) from the shards
               and restored on the (1, 2) ``plan_elastic_mesh`` gives 2
               ranks, every leaf ``torch.equal``.  The families
               (``MESH_FAMILIES``) train on (2, 2) and decode on (1, 4)
               against the single device under the same gates;
               recurrentgemma's attention on (2, 2) splits its 10 query
               heads while each rank projects only the one KV head they
               read.  whisper-tiny's first grad step also runs on
               (1, 4), where ``model`` does not divide its 6 heads: the
               ranks compute 2, 1, 2 and 1 of them in every attention
               (``spmd.rank_heads``), held to the same single-device
               gradients, each rank's launches the single device's,
               and rank 0's collectives equal the dry run's tally of
               the step on a dry (1, 4) mesh.  Rank 0's collectives in the qwen3 grad
               step under the default rules and SP_RULES (calls and
               bytes by kind) equal the dry run's tally of the same
               step on a dry (2, 2) mesh (gated).  Step ms and peak GB per rank, and
               the collectives' seconds and GB/s beside the dry run's
               predicted seconds, are readings.

Then a ``{"kernels": [...]}`` line (all six kernels, launches from the
serve, fleet, archs, tp, families, train, train_families, mesh and paper
paths, not the dryrun phase's anchors;
the dataflow GEMM's also counted apart for f32 operands,
``launches_f32``), the
card's name and power limit as ``nvidia-smi`` reports them, and as the
last line
``{"ok": true, "device": {...}}``.  The run uses ``cards`` cards (one
by default): the first ones ``CUDA_VISIBLE_DEVICES`` lists (from device
0 when it is unset).
Without a GPU, or without the rest of the repository beside this file,
it exits non-zero and prints no result.  It imports neither ``jax`` nor
the JAX package ``repro``.
"""
from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores

# bf16 outputs: kernel and plain version both accumulate in f32 but in
# different orders, then round to bf16 (8 significant bits, relative
# step 2^-8 = 0.0039); 2e-2 absolute + relative allows a few bf16 ulps
# of outputs of magnitude ~1 and no real error.
ATOL = RTOL = 2e-2
# parity: a served token must score within TAU of the best logit when
# the port's whole-sequence prefill re-scores it.  Logits of this
# random-init model have std ~0.6; bf16 rounding that differs between
# batched decode and whole prefill moves them by ~1e-3 per layer.
TAU = 0.05

N_REQUESTS, PROMPT_LEN, GEN = 16, 256, 32
# fleet phase: the router and churn sub-runs' requests (shared-prefix
# groups of FLEET_PREFIX + FLEET_TAIL = PROMPT_LEN tokens), the churn
# sub-run's script on the synthetic step clock (each hits live work:
# requests arrive at steps 0-7 and need ~15 steps each), the stream
# sub-run's requests, and the draft sub-run's shorter requests (the
# draft model consumes every context one token at a time)
FLEET_REQUESTS, FLEET_GROUPS, FLEET_PREFIX, FLEET_TAIL = 24, 4, 192, 64
CHURN_JOIN_AT, CHURN_DRAIN_AT, CHURN_CRASH_AT = 4, 8, 10
STREAM_REQUESTS = 16
DRAFT_REQUESTS, DRAFT_PROMPT_LEN, DRAFT_GEN = 8, 16, 8
# chunk starts of the kernel-level chunked == whole prefill check
CHUNK_STARTS = (0, 32, 224, 480)
# attention shapes (H, KVH, Dh) of the other served architectures
ATTN_SHAPES = {"qwen2_G7_dh64": (14, 2, 64), "stablelm_G1_dh64": (32, 32, 64),
               "scout_G5_dh128": (40, 8, 128),
               "qwen15_G8_dh128": (64, 8, 128),
               "deepseek_G1_dh128": (16, 16, 128),
               "qwen2vl_G7_dh128": (28, 4, 128)}
# the families' new attention cases: recurrentgemma's local attention
# (H 10, KVH 1, Dh 256, a 2,048-key window) and whisper-tiny's
# attention without a causal mask (H 6, Dh 64, 1,500 frames)
RG_HEADS, RG_DH, RG_WINDOW = (10, 1), 256, 2048
WHISPER_HEADS, WHISPER_DH, WHISPER_FRAMES = 6, 64, 1500
# archs phase: the architectures served on the card, and llama4-scout's
# cuts (depth to fit one card; capacity factor n_experts / top_k, so C =
# T and no token is dropped: a served token can then be re-scored by a
# whole prefill, whose dispatch shares no rows with the engine's)
ARCHS_ON_CARD = ("qwen2-0.5b", "stablelm-1.6b", "llama4-scout-17b-a16e")
SCOUT_LAYERS, SCOUT_CAPACITY = 4, 16.0
# tp phase: (arch, tp degrees) served at full size with every shard on
# the one card (named ``cuda:0``, so the shards time-share it), on
# TP_REQUESTS requests of the serve phase's lengths through TP_BATCH
# slots, so that half of them are admitted into the slots and pages the
# first half freed (the phase took 84-152 s at 16 requests through 8
# slots on an H100's host); the dispatch check's pool (pages of 16) and
# chunk length
TP_RUNS = (("qwen3-0.6b", (2, 4)), ("qwen2-0.5b", (2,)),
           ("stablelm-1.6b", (2,)))
TP_REQUESTS, TP_BATCH = 8, 4
TP_PAGES, TP_CHUNK = 16, 32
# families phase: the five lockstep-only families at full widths, with
# their prompt lengths (qwen2-vl: 256 patch positions + 64 text tokens;
# whisper: a 64-token decoder prompt over 1,500 stub frames;
# recurrentgemma: one 2,048-key window, the reference's S % window
# contract), 8 rows and GEN tokens each.  deepseek-moe runs at capacity
# factor 11 (its published 1.25 drops tokens by which rows share a
# call): int(T * 6 / 64 * 11) >= T, so C = T.  64 / 6 = 10.67 would
# give C = T - 1 at T = 2,048 from the float rounding of the product.
FAMILIES_ON_CARD = (("deepseek-moe-16b", 256), ("qwen2-vl-7b", 320),
                    ("whisper-tiny", 64), ("recurrentgemma-2b", 2048),
                    ("rwkv6-3b", 256))
FAMILY_ROWS = 8
DEEPSEEK_CAPACITY = 11.0
# the families' depths on the card where cut (widths as published; every
# gate at the cut depth): rwkv6's prompt runs the decode step token by
# token, 79 s of the phase's 142 s at every layer on an H100's host
FAMILY_LAYERS = {"rwkv6-3b": 4}
# decode extends prefill: the reference's own tolerance
# (tests/test_smoke_archs.py), on EXTEND_ROWS rows
EXTEND_TOL, EXTEND_ROWS = 4e-2, 2
# the scan-forms reading of the RG-LRU and RWKV6 stacks: rows, and the
# last prompt positions whose logits are compared
SCAN_ROWS, SCAN_LAST = 2, 8
# paper phase: the projections of the serving path (K, N) at these row
# counts (decode, verify, a chunk, a whole prefill)
PROJ_SHAPES = {"qwen3_attn_wq": (1024, 2048), "qwen3_ffn_wd": (3072, 1024),
               "scout_mix_wk": (5120, 1024)}
PROJ_ROWS = (8, 40, 256, 2048)
# paper phase: the products whose weight enters in f32 (``ParamSpec(
# f32=True)``), (K, N) and the row counts the card's paths give them:
# the MoE routers (decode, a chunk, a prefill), RG-LRU's gate (decode,
# recurrentgemma's 8 x 2,048-token prefill), RWKV6's decay LoRA
F32_SHAPES = {"scout_router": (5120, 16, (8, 256, 2048)),
              "deepseek_router": (2048, 64, (8, 2048)),
              "rglru_wr": (2560, 2560, (8, 16384)),
              "rwkv_wd1": (2560, 64, (8, 2048)),
              "rwkv_wd2": (64, 2560, (8, 2048))}
# kernels phase, the training path's cases: the attention backward
# (case, B, Sq, Skv, H, KVH, Dh, causal, window) at qwen3-0.6b's
# training shape, a long prompt, a ragged S, Dh 64 without a causal
# mask, and the families' training shapes: recurrentgemma's local
# attention (Dh 256, G 10, a 2,048-key window over 4,096 tokens),
# whisper's cross-attention (64 queries over 1,500 frames) and encoder,
# qwen2-vl's G 7 over 256 patches + 64 tokens; the GEMM backward's
# products (dX = dY W^T, dW = X^T dY) of qwen3's projections (K, N) at
# TRAIN_ROWS = B 8 x S 256 rows
FLASH_BWD_CASES = (
    ("qwen3_B8_S256", 8, 256, 256, 16, 8, 128, True, None),
    ("qwen3_B1_S2048", 1, 2048, 2048, 16, 8, 128, True, None),
    ("ragged_B2_S200", 2, 200, 200, 16, 8, 128, True, None),
    ("dh64_B2_S256_not_causal", 2, 256, 256, 16, 8, 64, False, None),
    ("rgemma_B1_S4096_w2048_dh256", 1, 4096, 4096, 10, 1, 256, True, 2048),
    ("whisper_cross_B8_64x1500", 8, 64, 1500, 6, 6, 64, False, None),
    ("whisper_enc_B8_1500", 8, 1500, 1500, 6, 6, 64, False, None),
    ("qwen2vl_B2_S320_G7", 2, 320, 320, 28, 4, 128, True, None))
GEMM_BWD_SHAPES = {"qwen3_attn_wq": (1024, 2048),
                   "qwen3_ffn_wd": (3072, 1024),
                   "qwen3_ffn_wg": (1024, 3072)}
# the backward of the products whose weight enters in f32, (K, N, M) at
# the train_families phase's rows: deepseek's router (B 4 x 256),
# RG-LRU's gate (B 1 x 4,096), RWKV6's decay LoRA (B 4 x 256)
GEMM_BWD_F32_SHAPES = {"deepseek_router": (2048, 64, 1024),
                       "rglru_wr": (2560, 2560, 4096),
                       "rwkv_wd1": (2560, 64, 1024),
                       "rwkv_wd2": (64, 2560, 1024)}
# the lse's tolerance: f32 log-sum-exps of 64-key tiles in two orders
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5
# train phase: qwen3-0.6b at full width through the launcher (B x S,
# steps, checkpoint interval, the resume run's injected fault); the
# gradient check at 2 of 28 layers (B 2 x S), its loss tolerance
# (absolute, on a loss of ~12) and each leaf's relative L2 tolerance
# against the CPU's plain path; the overfit run's steps
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 256, 10, 5
TRAIN_FAULT_AT = 7
TRAIN_ROWS = TRAIN_BATCH * TRAIN_SEQ
GRAD_LAYERS, GRAD_BATCH = 2, 2
GRAD_LOSS_TOL, GRAD_REL_L2 = 2e-2, 5e-2
OVERFIT_STEPS, PROFILE_STEPS = 8, 2
# the storage reading: steps of each run (the first one's time dropped)
STORAGE_STEPS = 5
# train_families phase: (arch, layers run or None for all, batch, seq,
# the comparison with the CPU: its layers (one block pattern; whisper
# one encoder and one decoder layer, whose 1,500-frame encoder layers
# took 58 s of the CPU's plain path at 4 + 4) and seq, through the
# launcher).  Full widths, f32
# parameters, AdamW,
# bf16 compute; the depth cuts keep the peak under ~70 GB: the port's
# step holds about 28 bytes a parameter (parameters, AdamW's two
# moments, the gradients and the step's new trees) plus a leaf's
# temporaries and the activations.  deepseek: 1 dense + 2 MoE layers
# (published capacity factor 1.25, so tokens drop as in the reference's
# training); recurrentgemma: two (RG-LRU, RG-LRU, local attention)
# patterns at S 4,096 > its 2,048-key window (S % window == 0, the
# reference's contract), compared with the CPU over one whole pattern
# at S 1,024 with the window cut to 512 (FAMILY_GRAD_CUTS), so that the
# window masks keys at model level, which it never did at S 2,048 =
# window (the local attention's plain forward, an elementwise product a
# key tile for row-stable bits, and the 256,000-entry unembedding took
# the CPU 84-89 s at one pattern over S 2,048; the published window's
# backward at S 4,096 is held against its plain version in the kernels
# phase).
# llama4-scout trains on the CPU only: one layer's
# 2.0 B expert parameters with its 2.07 B untied embedding and head
# need ~77 GB with Adam at 18 bytes a parameter.
FAMILY_TRAIN = (("whisper-tiny", None, 8, 64, 1, 64, True),
                ("deepseek-moe-16b", 3, 4, 256, 2, 256, False),
                ("qwen2-vl-7b", 3, 2, 320, 1, 320, False),
                ("recurrentgemma-2b", 6, 1, 4096, 3, 1024, False),
                ("rwkv6-3b", 16, 4, 256, 1, 256, False))
FAMILY_TRAIN_STEPS = 8
# the CPU comparison's config cuts beside its depth
FAMILY_GRAD_CUTS = {"recurrentgemma-2b": {"local_window": 512}}
# mesh phase: ranks as processes, all on the one card over gloo.
# qwen3-0.6b FULL on (data 2, model 2): gradients and MESH_STEPS steps of
# B x S; deepseek-moe at full widths on (1, 4) (16 of 64 experts a rank),
# MESH_MOE_LAYERS layers (the dense layer 0 and one MoE layer: the
# single-device reference's step and the ranks' copies fit the card);
# qwen3's prefill of B x S and MESH_DECODE_STEPS decode steps on the same
# (1, 4) ranks, the cache's sequence split over model; a checkpoint of a
# MESH_CKPT_LAYERS-layer qwen3 saved on (2, 2) and restored on the (1, 2)
# plan_elastic_mesh gives 2 ranks.  Tolerances: the train phase's card
# tolerances for loss and gradients (GRAD_LOSS_TOL, GRAD_REL_L2; the MoE
# routed as the single device routed, as train_families does); the
# MoE's final hidden states at C = T (so routed) and each decode step's
# logits within MESH_REL_TOL relative L2, with the share of elements
# outside the reference test's 2e-2 allclose a reading: the split
# products add their f32 partials before the one bf16 rounding, the
# single device's MoE adds its K outputs one bf16 rounding at a time,
# and 28 bf16 layers carry a one-ulp difference to ~0.03 on a logit
# near 0 (PERF.md); at its own capacity factor, routed on its
# own, more than 98 % of the MoE's elements within 3e-2
# (tests/test_multidevice.py)
MESH_ARCH, MESH_MOE = "qwen3-0.6b", "deepseek-moe-16b"
MESH_TRAIN_SHAPE, MESH_MOE_SHAPE = (2, 2), (1, 4)
MESH_B, MESH_S, MESH_STEPS, MESH_SEED = 8, 256, 2, 5
MESH_MOE_B, MESH_MOE_LAYERS = 4, 2
MESH_DECODE_STEPS = 8
MESH_CKPT_LAYERS = 1
MESH_REL_TOL = 2e-2
MESH_CLOSE_TOL, MESH_CLOSE_FRAC = 3e-2, 0.98
# the families on the mesh: (arch, layers or None for all, B, S) at full
# widths.  (2, 2): the first step's loss and gradients against the
# single device's on the card (GRAD_LOSS_TOL, GRAD_REL_L2), launches
# per rank equal, MESH_STEPS steps timed; (1, 4): a prefill of the same
# batch and MESH_FAMILY_DECODE_STEPS decode steps against the single
# device's (MESH_REL_TOL at every step), the caches and states cut as
# ``cache_specs`` places them.  whisper-tiny every layer (4 + 4), 1,500
# frames; recurrentgemma one (RG-LRU, RG-LRU, local attention) pattern
# at S 4,096, twice its 2,048-key window (its ring wrapped before the
# first decode step); rwkv6 2 of 32 layers.  On (2, 2) recurrentgemma's
# 10 heads split over model but its one KV head does not: each rank
# projects only that head (the one its 5 query heads read) and repeats
# it to them.  On (1, 4) whisper's 6 and recurrentgemma's 10 heads do
# not divide 4: a decode step runs their attention whole on every rank
# (the caches hold every head), their FFN / RG-LRU split; whisper's
# first grad step on (1, 4) splits its heads unevenly, 2 / 1 / 2 / 1 a
# rank (MESH_UNEVEN), held to the same single-device gradients.
MESH_FAMILIES = (("whisper-tiny", None, 8, 64),
                 ("recurrentgemma-2b", 3, 2, 4096),
                 ("rwkv6-3b", 2, 4, 256))
MESH_FAMILY_DECODE_STEPS = 8
MESH_UNEVEN = "whisper-tiny"
MESH_TIMEOUT_S = 600
MESH_DEVICE = "cuda:0"
# sequence parallelism (SP_RULES: the residual stream on sequence shards
# over model) beside the default rules, from one set of parameters and
# one batch: qwen3-0.6b FULL widths at MESH_SP_LAYERS layers inside the
# train job on (2, 2), deepseek-moe (MESH_MOE_LAYERS) inside the
# moe_decode job on (1, 4), routed as the single device's grad step;
# gates: the SP grad step's loss within GRAD_LOSS_TOL and every leaf
# within GRAD_REL_L2 relative L2 of the default step's, no leaf without
# a gradient, each rank's launches equal, and a forward alone with no
# all-reduce (every block's sums reduce-scattered)
MESH_SP_LAYERS = 2
# dryrun phase: the anchors' model and shapes (the train phase's B x S;
# a decode step over a cache of DRYRUN_PROMPT + GEN positions), the
# traced peak's tolerance against max_memory_allocated, and the
# production cells traced beside them (rank 0 of (16, 16); each with its
# config overrides: rwkv6-3b at 4 of 32 layers, one microbatch, traced
# in ~9 s, where its 32 layers at 8 microbatches took 483 s on the H100
# host's CPU beside the mesh phase)
DRYRUN_ARCH = "qwen3-0.6b"
DRYRUN_PROMPT = 256
DRYRUN_PEAK_TOL = 0.10
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", {}),
                ("qwen1.5-110b", "train_4k", {}),
                ("llama4-scout-17b-a16e", "train_4k", {}),
                ("rwkv6-3b", "train_4k", {"n_layers": "4"}))
DRYRUN_TIMEOUT_S = 300
# each production cell's FLOPs a device (``loop_aware.flops``, and the
# dataflow GEMM's share, ``kernels.gemm_dataflow.flops``) as the dry run
# traced them on a CPU once a rank of model projected only the KV heads
# its query heads read and, where model does not divide H, computed
# only its own run of whole heads, RWKV6's gate and LoRA weights formed
# only the rank's columns of their gradients (its decay's ``wd2`` only
# the rank's heads' channels), and the remat's recompute no longer
# formed a layer's dead last product (PERF.md sections 5 and 6); gated
# at or below each times 1 + DRYRUN_FLOPS_TOL, so that whole K/V
# products (qwen3 55.97 / 43.29 T), a whole attention on every rank
# (scout 2,651.5 T), a recomputed FFN down projection (qwen3 28.97 T,
# qwen1.5-110b 3,738.7 / 3,606.4 T, scout 650.6 T) and whole LoRA
# gradients on every rank (rwkv6 at 4 layers 28.45 T) fail
DRYRUN_FLOPS = {("qwen3-0.6b", "train_4k"): (28245105637498.0,
                                             15633680957440.0),
                ("qwen1.5-110b", "train_4k"): (3474821506392298.0,
                                               3342515348439040.0),
                ("llama4-scout-17b-a16e", "train_4k"): (634074951134721.0,
                                                        315422398218240.0),
                ("rwkv6-3b", "train_4k"): (27645074697718.0,
                                           23293755129856.0)}
DRYRUN_FLOPS_TOL = 0.01
# the model-level bitwise invariants: 8 prompts of mixed lengths, fed in
# chunks of the serve phase's chunk size, pages of 16
BITWISE_LENS = (256, 241, 200, 177, 130, 96, 64, 33)
BITWISE_CHUNK = 32

# paper phase.  llama4-scout's expert up-projection (tokens x d_model @
# d_model x d_ff), the GEMM of benchmarks/kernel_dataflow.py
SCOUT_M, SCOUT_K, SCOUT_N = 8192, 5120, 8192
KEEP_RATES = (0.36, 0.27, 0.35, 0.38)      # the paper's Table-3 rates
# f32 outputs of a K-5120 product: kernel and plain version sum 5120
# products of magnitude ~1 in two orders (tensor-core or FMA tile
# products vs cuBLAS f32 panels), so outputs of magnitude ~70 differ by
# ~1e-3; 1e-2 + 1e-4 |want| allows that and no real error
GEMM_ATOL, GEMM_RTOL = 1e-2, 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> "None":
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------- timing
def _flush_l2(buf) -> None:
    buf.zero_()                      # 256 MB > the 50 MB L2


def time_ms(fn, *, iters: int = 20, flush=None,
            budget_ms: float = None) -> float:
    """Median device time of one call, CUDA events around each call,
    L2 flushed between calls when ``flush`` is given (in the serve path
    each of the 28 layers reads its own K/V).  With ``budget_ms`` the
    number of calls is cut (to no fewer than 3) so that they take about
    that long in all."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    if budget_ms is not None:
        iters = max(3, min(iters, int(budget_ms / max(a.elapsed_time(b),
                                                      1e-3))))
    times = []
    for _ in range(iters):
        if flush is not None:
            _flush_l2(flush)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, calls: int = 10, by_kernel: bool = False):
    """Device time of one call of ``fn``: the kernels' own time summed
    from a ``torch.profiler`` trace of ``calls`` back-to-back calls
    (after one warm-up call), host launch gaps excluded (included
    where the trace holds no device event).  At decode
    sizes a call's host work (the wrapper, two launches) can outlast
    the L2 flush that ``time_ms`` puts before it, and then ``time_ms``
    reads the host's time as well.  With ``by_kernel``, also {kernel
    name: ms a call}."""
    fn()
    prof = _device_profile(lambda: [fn() for _ in range(calls)])
    total = prof["device_busy_ms"] / calls
    if total <= 0:
        # the trace holds no device event (seen on one H100 host for a
        # library GEMM): CUDA events around the same back-to-back calls,
        # the host's launch gaps included, and no split by kernel
        total = time_ms(lambda: [fn() for _ in range(calls)],
                        iters=3) / calls
        return (total, {}) if by_kernel else total
    if not by_kernel:
        return total
    return total, {_kernel_name_of(name): ms / calls
                   for name, ms, _ in prof["top"]}


def _kernel_name_of(signature: str) -> str:
    """A profiler kernel name without return type, namespace and
    parameter list (``flash_bwd_dq<128>``)."""
    name = signature.replace("(anonymous namespace)::", "")
    name = name.split("(", 1)[0].removeprefix("void ")
    return name.rsplit("::", 1)[-1]


def bound_ms(n_bytes: float, n_flops: float,
             flops_per_s: float = BF16_FLOPS_PER_S):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = n_flops / flops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def max_err(got, want, atol: float = ATOL, rtol: float = RTOL):
    """(max |got - want|, within atol + rtol * |want| everywhere)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    ok = bool((d <= atol + rtol * w.abs()).all()) and bool(
        torch_isfinite(g))
    return float(d.max()), ok


def torch_isfinite(x) -> bool:
    import torch
    return bool(torch.isfinite(x).all())


# ----------------------------------------------------------- phases
def phase_env():
    import torch
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    took = build.build()
    rec = {"phase": "env", "torch": torch.__version__,
           "cuda": torch.version.cuda, "python": sys.version.split()[0],
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": nvidia_smi_line(),
           "build_s": round(time.perf_counter() - t0, 3),
           "build_s_per_kernel": {k: round(v, 3) for k, v in took.items()}}
    for name in build.SOURCES:
        rec[f"ptxas_{name}"] = _ptxas_summary(build.build_log(name))
    if torch.cuda.device_count() > 1:
        rec.update(_card_links(torch.cuda.device_count()))
    emit(rec)


def _card_links(cards: int) -> dict:
    """How the cards talk, for the mesh's readings: ``nvidia-smi topo -m``
    and ``nvlink --status`` as printed (some hosts refuse them), peer
    access between every pair, and the rate of a 256 MB copy from
    ``cuda:0`` to ``cuda:1`` (median of 10; NVLink moves several times
    what a PCIe link can)."""
    import statistics
    import torch

    def smi(*args):
        out = subprocess.run(["nvidia-smi", *args], capture_output=True,
                             text=True, timeout=60)
        return (out.stdout + out.stderr).strip()
    src = torch.empty(256 << 20, dtype=torch.uint8, device="cuda:0")
    dst = torch.empty_like(src, device="cuda:1")
    ts = []
    for _ in range(11):
        torch.cuda.synchronize(0)
        torch.cuda.synchronize(1)
        t = time.perf_counter()
        dst.copy_(src)
        torch.cuda.synchronize(0)
        torch.cuda.synchronize(1)
        ts.append(time.perf_counter() - t)
    del src, dst
    return {"cards": cards, "topology": smi("topo", "-m"),
            "nvlink": smi("nvlink", "--status"),
            "peer_access": [[i == j or torch.cuda.can_device_access_peer(
                i, j) for j in range(cards)] for i in range(cards)],
            "copy_0_to_1_gb_per_s": (256 << 20) / statistics.median(
                ts[1:]) / 1e9}


def _kernel_name(mangled: str) -> str:
    """A kernel's demangled name without its parameter list
    (``pipe::gemm_bf16<0>``); without c++filt, its last identifier."""
    try:
        out = subprocess.run(["c++filt", mangled], capture_output=True,
                             text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = mangled
    if out == mangled:
        found = re.findall(r"\d+([a-z][a-z0-9_]+?)(?:I|E)", mangled)
        return found[-1] if found else mangled
    name = out.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return name.split(" ", 1)[-1]


def _ptxas_summary(log: str):
    """One line per kernel of ptxas's -v report: registers, shared
    memory and spill bytes."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = _kernel_name(m.group(1))
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            used = ln.split("Used", 1)[1].strip()
            out.append(f"{name}: {used}; {spill}")
            name, spill = None, ""
    return out


def _paged_case(B, T, lengths, *, seed, P=154, H=16, KVH=8, Dh=128):
    """Inputs of one paged-attention call, by default at qwen3-0.6b
    shapes: a pool of P pages of 16 (154: the size the serve phase
    sizes), ragged lengths, distinct random pages per row."""
    import torch
    ps = 16
    n = -(-(max(lengths) + T) // ps)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn(B, T, H, Dh, generator=g, device=dev).bfloat16()
    kp = torch.randn(P, ps, KVH, Dh, generator=g, device=dev).bfloat16()
    vp = torch.randn(P, ps, KVH, Dh, generator=g, device=dev).bfloat16()
    perm = torch.randperm(P - 1, generator=g, device=dev) + 1
    tables = torch.zeros(B, n, dtype=torch.int32, device=dev)
    used = 0
    for b, ln in enumerate(lengths):
        k = -(-(ln + T) // ps)
        tables[b, :k] = perm[used:used + k].int()
        used += k
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, lens


def _paged_numbers(q, kp, vp, tables, lens):
    B, T, H, Dh = q.shape
    KVH, ps = kp.shape[2], kp.shape[1]
    keys = [min(int(ln) + T, tables.shape[1] * ps) for ln in lens.tolist()]
    kv_bytes = sum(keys) * KVH * Dh * 2 * 2
    io_bytes = 2 * q.numel() * 2 + tables.numel() * 4 + lens.numel() * 4
    flops = sum(4 * T * H * Dh * k for k in keys)
    return kv_bytes + io_bytes, flops


def _paged_blocks(q, kp, tables, lens, split):
    """(blocks launched, blocks with keys to read) of the kernel's grid:
    one block per (b, kv head, row group of <= 16 query rows, key split
    of ``split`` keys anchored at position 0); a split past its row
    group's last key does no work."""
    B, T, H, _ = q.shape
    ps, KVH = kp.shape[1], kp.shape[2]
    G, cover = H // KVH, tables.shape[1] * ps
    groups = -(-T * G // 16)
    work = 0
    for ln in lens.tolist():
        for rg in range(groups):
            last = min(T * G, 16 * (rg + 1)) - 1
            work += KVH * -(-min(ln + last // G + 1, cover) // split)
    return B * KVH * groups * -(-cover // split), work


def _sdpa_paged(q, kp, vp, tables, lens):
    """SDPA over K/V gathered from the pages beforehand (the gather is
    not timed): the library yardstick for the paged kernel."""
    import torch
    import torch.nn.functional as F
    B, T, H, Dh = q.shape
    ps = kp.shape[1]
    n = tables.shape[1]
    k = kp[tables.long()].reshape(B, n * ps, *kp.shape[2:]).transpose(1, 2)
    v = vp[tables.long()].reshape(B, n * ps, *vp.shape[2:]).transpose(1, 2)
    k, v = k.contiguous(), v.contiguous()
    qpos = lens.long()[:, None] + torch.arange(T, device=q.device)[None]
    mask = (torch.arange(n * ps, device=q.device)[None, None]
            <= qpos[:, :, None])[:, None]
    qt = q.transpose(1, 2).contiguous()

    def call():
        return F.scaled_dot_product_attention(qt, k, v, attn_mask=mask,
                                              enable_gqa=True)
    return call


def _flash_numbers(q, k, v, q_offset, causal, window=None):
    B, Sq, H, Dh = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    keys = []
    for b in range(B):
        off = int(q_offset[b])
        for i in range(Sq):
            n = min(Skv, off + i + 1) if causal else Skv
            keys.append(min(n, window) if window else n)
    kmax = [min(Skv, int(q_offset[b]) + Sq) if causal else Skv
            for b in range(B)]
    kv_bytes = sum(kmax) * KVH * Dh * 2 * 2
    io_bytes = 2 * q.numel() * 2 + B * 4
    flops = 4 * H * Dh * sum(keys)
    return kv_bytes + io_bytes, flops


def _sdpa_flash(q, k, v, q_offset, causal, window=None):
    import torch
    import torch.nn.functional as F
    B, Sq = q.shape[:2]
    Skv = k.shape[1]
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    mask = None
    if causal:
        qpos = q_offset.long()[:, None] + torch.arange(Sq, device=q.device)
        j = torch.arange(Skv, device=q.device)[None, None]
        mask = j <= qpos[:, :, None]
        if window:
            mask = mask & (j > qpos[:, :, None] - window)
        mask = mask[:, None]

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    return call


def _paged_bitwise(kernel, q, kp, vp, tables, lens, got) -> bool:
    """The properties the engine's token-exactness rests on, held by
    the kernel itself: query t of a T-token call == the one-token call
    at lengths + t; a wider table changes no bit; a row alone == the
    row in the batch."""
    import torch
    T = q.shape[1]
    wider = torch.cat([tables, torch.zeros_like(tables[:, :3])], 1)
    ok = torch.equal(kernel(q, kp, vp, wider, lens), got)
    for t in range(T):
        one = kernel(q[:, t:t + 1].contiguous(), kp, vp, tables, lens + t)
        ok = ok and torch.equal(one[:, 0], got[:, t])
    alone = kernel(q[1:2], kp, vp, tables[1:2], lens[1:2])
    return ok and torch.equal(alone, got[1:2])


def _contiguous_equals_paged(seed, H=16, KVH=8, Dh=128) -> bool:
    """The contiguous decode (``components.decode_attention``: the cache
    viewed as one page of S_max = 304 keys per row, not a multiple of
    the key split) gives the bits of the paged decode over the same keys
    in pages of 16, by default at qwen3-0.6b shapes."""
    import torch
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.models.components import decode_attention
    B, ps, S, pos = 8, 16, 304, 297
    g = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn(B, S, KVH, Dh, generator=g, device="cuda").bfloat16()
    v = torch.randn(B, S, KVH, Dh, generator=g, device="cuda").bfloat16()
    q = torch.randn(B, 1, H, Dh, generator=g, device="cuda").bfloat16()
    null = torch.zeros(1, ps, KVH, Dh, dtype=k.dtype, device="cuda")
    kp = torch.cat([null, k.reshape(B * S // ps, ps, KVH, Dh)])
    vp = torch.cat([null, v.reshape(B * S // ps, ps, KVH, Dh)])
    tables = (torch.arange(B * S // ps, dtype=torch.int32, device="cuda")
              .reshape(B, S // ps) + 1)
    lens = torch.full((B,), pos - 1, dtype=torch.int32, device="cuda")
    return torch.equal(decode_attention(q, k, v, pos),
                       paged_attention(q, kp, vp, tables, lens))


def _flash_bitwise(kernel, q, k, v, off, got, causal=True,
                   window=None) -> bool:
    """A row alone == the row in the batch; causal: keys past every
    row's causal frontier (a longer buffer) change no bit; not causal:
    rows 32..63 called alone over the same keys == those rows of the
    whole call."""
    import torch
    kw = dict(causal=causal, window=window)
    alone = kernel(q[1:2], k[1:2], v[1:2], q_offset=off[1:2], **kw)
    ok = torch.equal(alone, got[1:2])
    if causal:
        pad = torch.randn_like(k[:, :64])
        longer = kernel(q, torch.cat([k, pad], 1), torch.cat([v, pad], 1),
                        q_offset=off, **kw)
        return ok and torch.equal(longer, got)
    rows = kernel(q[:, 32:64].contiguous(), k, v, q_offset=off, **kw)
    return ok and torch.equal(rows, got[:, 32:64])


def _flash_chunked_equals_whole(kernel, q, k, v, whole,
                                window=None) -> bool:
    """Each row of a 32-row call at q_offset s over the first s + 32
    keys equals the same row of the whole prefill, for s in CHUNK_STARTS:
    chunked == whole prefill, held by the kernel itself."""
    import torch
    ok = True
    for s in CHUNK_STARTS:
        off = torch.full((q.shape[0],), s, dtype=torch.int32,
                         device=q.device)
        part = kernel(q[:, s:s + 32].contiguous(),
                      k[:, :s + 32].contiguous(), v[:, :s + 32].contiguous(),
                      q_offset=off, causal=True, window=window)
        ok = ok and torch.equal(part, whole[:, s:s + 32])
    return ok


def _sdpa_bwd(q, k, v, dout, causal, window=None):
    """SDPA's backward on the same inputs and mask (its forward run
    beforehand, not timed): the library yardstick of the attention
    backward.  A window goes in as a boolean mask."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    mask = None
    if window:
        i = torch.arange(q.shape[1], device=q.device)[:, None]
        j = torch.arange(k.shape[1], device=q.device)[None]
        mask = (j > i - window) & ((j <= i) if causal else True)
    out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)
    dt = dout.transpose(1, 2).contiguous()

    def call():
        return torch.autograd.grad(out, (qt, kt, vt), dt,
                                   retain_graph=True)
    return call


def _flash_bwd_cases(g, flush, results) -> None:
    """The attention backward (``flash_attention_bwd``: the dQ kernel,
    then the dK/dV kernel) at FLASH_BWD_CASES against its plain version
    on the same inputs (dq, dk, dv within ATOL / RTOL), the forward's
    lse against the plain forward's, and two calls bit for bit equal
    (no atomics); timed beside the plain version, SDPA's backward and
    the bound (the bytes of q, k, v, do, lse, dq, dk, dv; 2.5 times the
    forward's operations: five products of its size)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").bfloat16()
    for case, B, Sq, Skv, H, KVH, Dh, causal, window in FLASH_BWD_CASES:
        q, k, v, do = (rnd(B, Sq, H, Dh), rnd(B, Skv, KVH, Dh),
                       rnd(B, Skv, KVH, Dh), rnd(B, Sq, H, Dh))
        out, lse = fa.flash_attention_lse(q, k, v, causal, window)
        serve_bits = torch.equal(out, fa.flash_attention(
            q, k, v, causal=causal, window=window))
        _, lse_plain = fa.flash_attention_plain(q, k, v, causal=causal,
                                                window=window,
                                                return_lse=True)
        args = (q, k, v, lse, do, causal, window)
        plan = fa.plan_dkdv(Sq, Skv, H // KVH, causal, window)
        got = fa.flash_attention_bwd(*args)
        dev = device_ms(lambda: fa.flash_attention_bwd(*args),
                        by_kernel=True)
        again = fa.flash_attention_bwd(*args)
        want = fa.flash_attention_bwd_plain(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        errs = {n: max_err(a, b) for n, a, b in zip(("dq", "dk", "dv"),
                                                     got, want)}
        lse_err, lse_ok = max_err(lse, lse_plain, LSE_ATOL, LSE_RTOL)
        zeros = torch.zeros(B, dtype=torch.int32)
        fwd_bytes, fwd_flops = _flash_numbers(q, k, v, zeros, causal,
                                              window)
        n_bytes = (3 * q.numel() + 4 * k.numel()) * 2 + lse.numel() * 4
        flops = 2.5 * fwd_flops
        b_ms, b_by = bound_ms(n_bytes, flops)
        ok = all(o for _, o in errs.values())
        rec = {"phase": "kernels", "kernel": "flash_attention_bwd",
               "case": case, "B": B, "Sq": Sq, "Skv": Skv, "H": H,
               "KVH": KVH, "Dh": Dh, "causal": causal, "window": window,
               "max_abs_err": max(e for e, _ in errs.values()),
               "max_abs_err_by_grad": {n: e for n, (e, _) in errs.items()},
               "atol": ATOL, "rtol": RTOL, "ok": ok,
               "lse_max_abs_err": lse_err, "lse_ok": lse_ok,
               "forward_out_equals_serving": serve_bits,
               "deterministic": same,
               "ms": time_ms(lambda: fa.flash_attention_bwd(*args),
                             flush=flush),
               "plain_ms": time_ms(lambda: fa.flash_attention_bwd_plain(
                   *args), iters=3, flush=flush),
               "library_ms": time_ms(_sdpa_bwd(q, k, v, do, causal,
                                               window), flush=flush),
               "device_ms": dev[0], "device_ms_by_kernel": dev[1],
               "library_device_ms": device_ms(
                   _sdpa_bwd(q, k, v, do, causal, window)),
               "plan_dkdv": {"chunk": plan.chunk, "blocks_per_row_head":
                             len(plan.items), "workspace_slots":
                             plan.n_slots},
               "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
               "flops": flops, "forward_flops": fwd_flops}
        emit(rec)
        if not ok:
            fail(f"flash_attention_bwd [{case}] disagrees with its plain "
                 f"version: {errs}")
        if not lse_ok:
            fail(f"flash_attention [{case}]: the lse is {lse_err} from the "
                 "plain forward's")
        if not (same and serve_bits):
            fail(f"flash_attention_bwd [{case}]: two calls differ "
                 f"({not same}) or the lse forward moved the output's bits "
                 f"({not serve_bits})")
        results.setdefault("flash_attention_bwd", []).append(rec)


def _gemm_bwd_cases(g, flush, results) -> None:
    """The projections' backward on the dataflow GEMM as ``LinearFn``
    runs it, at qwen3's training shapes (TRAIN_ROWS rows): dX = dY W^T
    and dW = X^T dY, the transposed operand made contiguous first; the
    kernel (f32 out) against the f32 product of the same bf16 operands
    within the GEMM tolerance, timed beside its plain version, cuBLAS
    (``torch.matmul`` on the transposed view, bf16 out) and the bound,
    and with the transpose copy (``with_transpose_ms``)."""
    import torch
    from repro_torch.kernels import gemm_dataflow as gd
    M = TRAIN_ROWS
    for label, (K, N) in GEMM_BWD_SHAPES.items():
        x = torch.randn(M, K, generator=g, device="cuda").bfloat16()
        w = torch.randn(K, N, generator=g, device="cuda").bfloat16()
        dy = torch.randn(M, N, generator=g, device="cuda").bfloat16()
        for grad, (a_of, b_of, view) in (
                ("dX", (lambda: dy, lambda: w.t().contiguous(),
                        lambda: (dy, w.t()))),
                ("dW", (lambda: x.t().contiguous(), lambda: dy,
                        lambda: (x.t(), dy)))):
            a, b = a_of(), b_of()
            got = gd.matmul(a, b)
            err, ok = max_err(got, a.float() @ b.float(), GEMM_ATOL,
                              GEMM_RTOL)
            m, kk = a.shape
            n = b.shape[1]
            n_bytes = (m * kk + kk * n) * 2 + m * n * 4
            flops = 2 * m * n * kk
            b_ms, b_by = bound_ms(n_bytes, flops)
            t_k = time_ms(lambda: gd.matmul(a, b), flush=flush)
            t_l = time_ms(lambda: torch.matmul(*view()), flush=flush)
            rec = {"phase": "kernels", "kernel": "gemm_dataflow",
                   "case": f"bwd_{grad}_{label}_M{M}",
                   "dataflow": "output_stationary", "M": m, "K": kk, "N": n,
                   "dtype": "bfloat16", "max_abs_err": err,
                   "atol": GEMM_ATOL, "rtol": GEMM_RTOL, "ok": ok,
                   "ms": t_k,
                   "plain_ms": time_ms(lambda: gd.matmul_plain(a, b),
                                       iters=3, flush=flush),
                   "library_ms": t_l,
                   "with_transpose_ms": time_ms(
                       lambda: gd.matmul(a_of(), b_of()), flush=flush),
                   "kernel_over_library": t_k / t_l,
                   "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
                   "flops": flops}
            emit(rec)
            if not ok:
                fail(f"gemm_dataflow [{rec['case']}] disagrees with the f32 "
                     f"product: max abs err {err}")
            results.setdefault("gemm_dataflow_bwd", []).append(rec)


def _gemm_bwd_f32_cases(g, flush, results) -> None:
    """``LinearFn``'s backward products for the weights that enter in
    f32 (GEMM_BWD_F32_SHAPES: dX = dY W^T, dW = X^T dY on the f32
    output-stationary kernel, ``gemm_f32.cuh``) against the plain
    version within the GEMM tolerance, timed beside ``torch.matmul``
    (f32, TF32 off) and the bound (operations at the f32 rate)."""
    import torch
    from repro_torch.kernels import gemm_dataflow as gd
    for label, (K, N, M) in GEMM_BWD_F32_SHAPES.items():
        x = torch.randn(M, K, generator=g, device="cuda")
        w = torch.randn(K, N, generator=g, device="cuda")
        dy = torch.randn(M, N, generator=g, device="cuda")
        for grad, (a, b) in (("dX", (dy, w.t().contiguous())),
                             ("dW", (x.t().contiguous(), dy))):
            got = gd.matmul(a, b)
            err, ok = max_err(got, gd.matmul_plain(a, b), GEMM_ATOL,
                              GEMM_RTOL)
            m, kk = a.shape
            n = b.shape[1]
            n_bytes = (m * kk + kk * n + m * n) * 4
            flops = 2 * m * n * kk
            b_ms, b_by = bound_ms(n_bytes, flops, F32_FLOPS_PER_S)
            rec = {"phase": "kernels", "kernel": "gemm_dataflow",
                   "case": f"bwd_f32_{grad}_{label}_M{M}",
                   "dataflow": "output_stationary", "M": m, "K": kk, "N": n,
                   "dtype": "float32", "max_abs_err": err,
                   "atol": GEMM_ATOL, "rtol": GEMM_RTOL, "ok": ok,
                   "ms": time_ms(lambda: gd.matmul(a, b), flush=flush),
                   "device_ms": device_ms(lambda: gd.matmul(a, b)),
                   "plain_ms": time_ms(lambda: gd.matmul_plain(a, b),
                                       iters=3, flush=flush),
                   "library_ms": time_ms(lambda: torch.matmul(a, b),
                                         flush=flush),
                   "library_device_ms": device_ms(
                       lambda: torch.matmul(a, b)),
                   "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
                   "flops": flops}
            emit(rec)
            if not ok:
                fail(f"gemm_dataflow [{rec['case']}] disagrees with its "
                     f"plain version: max abs err {err}")
            results.setdefault("gemm_dataflow_bwd", []).append(rec)


def _every_card(cards: int) -> dict:
    """Every kernel launched on ``cuda:0``, then on ``cuda:1`` .. in this
    one process (a function's attributes, such as its dynamic shared
    memory, belong to each device's context), each against its plain
    version on the same inputs at the kernels phase's tolerances:
    attention forward and backward and the paged decode at qwen3-0.6b's
    shapes, the GEMM in bf16 and f32, the block-sparse GEMM and the LUT.
    A launch that raises is recorded with its error.  Returns the
    record; ``ok`` when every kernel held on every card."""
    import torch
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels import gemm_dataflow as gd
    from repro_torch.kernels import lut_activation as lut
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa

    def flash_bwd(q, k, v, do):
        _, lse = fa.flash_attention_lse(q, k, v, True, None)
        args = (q, k, v, lse, do, True, None)
        return fa.flash_attention_bwd(*args), fa.flash_attention_bwd_plain(
            *args)
    by_card = {}
    for d in range(cards):
        with torch.cuda.device(d):
            g = torch.Generator(device="cuda").manual_seed(3)

            def rnd(*shape, dt=torch.bfloat16):
                return torch.randn(*shape, generator=g, device="cuda").to(dt)
            q, do = rnd(2, 256, 16, 128), rnd(2, 256, 16, 128)
            k, v = rnd(2, 256, 8, 128), rnd(2, 256, 8, 128)
            a, w = rnd(256, 1024), rnd(1024, 2048)
            a32, w32 = rnd(1000, 1024, dt=torch.float32), rnd(
                1024, 1000, dt=torch.float32)
            mask = np.random.default_rng(3).random((8, 16)) < 0.36
            x = _lut_x(g, 256, 1024, 2.0)
            paged = _paged_case(8, 1, [100, 37, 255, 1, 64, 129, 16, 200],
                                seed=5)
            cases = {
                "flash_attention": lambda: (
                    fa.flash_attention(q, k, v, causal=True),
                    fa.flash_attention_plain(q, k, v, causal=True)),
                "flash_attention_bwd": lambda: flash_bwd(q, k, v, do),
                "paged_attention": lambda: (pa.paged_attention(*paged),
                                            pa.paged_attention_plain(*paged)),
                "gemm_dataflow": lambda: (gd.matmul(a, w),
                                          gd.matmul_plain(a, w)),
                "gemm_dataflow_f32": lambda: (gd.matmul(a32, w32),
                                              gd.matmul_plain(a32, w32)),
                "block_sparse": lambda: (bs.matmul(a, w, mask),
                                         bs.matmul_plain(a, w, mask)),
                "lut_activation": lambda: (
                    lut.apply_lut(x, "silu"),
                    lut.lut_plain(x, lut.table_for("silu", str(x.device))))}
            tol = {"gemm_dataflow": (GEMM_ATOL, GEMM_RTOL),
                   "gemm_dataflow_f32": (GEMM_ATOL, GEMM_RTOL)}
            card = by_card[f"cuda:{d}"] = {}
            for name, run in cases.items():
                try:
                    got, want = run()
                    got, want = ((got, want) if isinstance(got, tuple)
                                 else ((got,), (want,)))
                    errs = [max_err(a_, b_, *tol.get(name, (ATOL, RTOL)))
                            for a_, b_ in zip(got, want)]
                    torch.cuda.synchronize()
                    card[name] = {"max_abs_err": max(e for e, _ in errs),
                                  "ok": all(o for _, o in errs)}
                except Exception as e:                # noqa: BLE001
                    card[name] = {"ok": False, "error": str(e)[:300]}
    return {"phase": "kernels", "check": "every_card", "cards": cards,
            "by_card": by_card,
            "ok": all(r["ok"] for c in by_card.values() for r in c.values())}


def phase_kernels():
    """Each kernel vs its plain version at the main path's shapes; where
    more than one card is visible, each kernel on every card in turn
    (``_every_card``)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import components as Cm
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    results = {}
    # what this way of timing reads for a kernel that does next to
    # nothing: one 4-byte memset, timed as the kernels below are
    emit({"phase": "kernels", "check": "timing_floor",
          "memset_4_bytes_ms": time_ms(lambda: flush[:1].zero_(),
                                       flush=flush)})

    def record(kernel, case, got, want, bitwise, t_k, t_p, t_l, n_bytes,
               flops, **shape):
        err, ok = max_err(got, want)
        b_ms, b_by = bound_ms(n_bytes, flops)
        rec = {"phase": "kernels", "kernel": kernel, "case": case,
               **shape, "max_abs_err": err, "atol": ATOL, "rtol": RTOL,
               "ok": ok, "bitwise_invariants": bitwise, "ms": t_k,
               "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
               "bound_by": b_by, "bytes": n_bytes, "flops": flops}
        emit(rec)
        if not ok:
            fail(f"{kernel} [{case}] disagrees with its plain version: "
                 f"max abs err {err}")
        if not bitwise:
            fail(f"{kernel} [{case}]: a row's bits depend on more than "
                 "its own keys")
        results.setdefault(kernel, []).append(rec)

    def paged(case, T, lengths, P, seed, shape):
        args = _paged_case(len(lengths), T, lengths, seed=seed, P=P, **shape)
        got = pa.paged_attention(*args)
        want = pa.paged_attention_plain(*args)
        bitwise = _paged_bitwise(pa.paged_attention, *args, got)
        torch.cuda.synchronize()
        n_bytes, flops = _paged_numbers(*args)
        grid, working = _paged_blocks(args[0], args[1], args[3], args[4],
                                      pa.SPLIT)
        record("paged_attention", case, got, want, bitwise,
               time_ms(lambda: pa.paged_attention(*args), flush=flush),
               time_ms(lambda: pa.paged_attention_plain(*args), iters=5,
                       flush=flush),
               time_ms(_sdpa_paged(*args), flush=flush),
               n_bytes, flops, B=len(lengths), T=T, H=args[0].shape[2],
               KVH=args[1].shape[2], Dh=args[0].shape[3], lengths=lengths,
               pool_pages=P,
               split=pa.SPLIT, grid_blocks=grid, working_blocks=working)

    def ring_case(case, args, shape):
        """Paged attention over pages of a whole ring each."""
        got = pa.paged_attention(*args)
        want = pa.paged_attention_plain(*args)
        bitwise = _paged_bitwise(pa.paged_attention, *args, got)
        torch.cuda.synchronize()
        n_bytes, flops = _paged_numbers(*args)
        grid, working = _paged_blocks(args[0], args[1], args[3], args[4],
                                      pa.SPLIT)
        record("paged_attention", case, got, want, bitwise,
               time_ms(lambda: pa.paged_attention(*args), flush=flush),
               time_ms(lambda: pa.paged_attention_plain(*args), iters=3,
                       flush=flush),
               time_ms(_sdpa_paged(*args), flush=flush),
               n_bytes, flops, B=args[0].shape[0], T=1, **shape,
               lengths=args[4].tolist(), page_size=args[1].shape[1],
               split=pa.SPLIT, grid_blocks=grid, working_blocks=working)

    def contiguous(label, seed, **shape):
        same = _contiguous_equals_paged(seed, **shape)
        emit({"phase": "kernels", "check": "contiguous_decode_equals_paged",
              "shape": label, "B": 8, "S_max": 304, "page_size": 16,
              **shape, "equal": same})
        if not same:
            fail(f"paged_attention [{label}]: the contiguous decode gives "
                 "other bits than the paged decode over the same keys")

    def flash(case, q, k, v, off, causal=True, window=None, bitwise=None,
              **extra):
        kw = dict(causal=causal, window=window)
        got = fa.flash_attention(q, k, v, q_offset=off, **kw)
        want = fa.flash_attention_plain(q, k, v, q_offset=off, **kw)
        if bitwise is None:
            bitwise = _flash_bitwise(fa.flash_attention, q, k, v, off, got,
                                     **kw)
        chunked = None
        if case.startswith("prefill"):
            chunked = _flash_chunked_equals_whole(fa.flash_attention, q, k,
                                                  v, got, window)
            if not chunked:
                fail(f"flash_attention [{case}]: a 32-row chunk gives other "
                     "bits than the same rows of the whole prefill")
        torch.cuda.synchronize()
        n_bytes, flops = _flash_numbers(q, k, v, off.tolist(), causal,
                                        window)
        record("flash_attention", case, got, want, bitwise,
               time_ms(lambda: fa.flash_attention(q, k, v, q_offset=off,
                                                  **kw), flush=flush),
               time_ms(lambda: fa.flash_attention_plain(
                   q, k, v, q_offset=off, **kw), iters=3,
                   flush=flush),
               time_ms(_sdpa_flash(q, k, v, off, causal, window),
                       flush=flush),
               n_bytes, flops, B=q.shape[0], Sq=q.shape[1],
               Skv=k.shape[1], H=q.shape[2], KVH=k.shape[2], Dh=q.shape[3],
               q_offset=off.tolist(), causal=causal, window=window,
               chunked_equals_whole=chunked, **extra)

    def decode_row(case, q, k, v, pos, *, s_max=None, window=None,
                   causal=True):
        """Row ``pos`` of q (B 8, L, H, Dh) over the keys k, v (B, Lk,
        KVH, Dh) as a family's decode step computes it: causal, through
        ``components.flash_decode_attention`` over a cache of s_max slots
        (the slots past pos hold other keys) or over a ring of ``window``
        slots (slot = position % window); not causal (cross-attention),
        one query row over every key.  Held against the plain version on
        the kernel's inputs (``flash``) and over the linear history, and
        bitwise against row pos of the whole call over the linear
        history and against the row alone."""
        B, kv_shape = q.shape[0], k.shape[2:]
        qd = q[:, pos:pos + 1].contiguous()
        zeros = torch.zeros(B, dtype=torch.int32, device="cuda")
        whole = fa.flash_attention(q, k, v, q_offset=zeros, causal=causal,
                                   window=window)
        if not causal:
            kc, vc, ka, va, off = k, v, k, v, 0

            def step(qq, kk, vv):
                return fa.flash_attention(qq, kk, vv, q_offset=0,
                                          causal=False)
        else:
            if window is None:
                kc = torch.cat([k, rnd(B, s_max - pos - 1, *kv_shape)], 1)
                vc = torch.cat([v, rnd(B, s_max - pos - 1, *kv_shape)], 1)
            else:
                kc, vc = rnd(B, window, *kv_shape), rnd(B, window, *kv_shape)
                held = torch.arange(max(0, pos + 1 - window), pos + 1,
                                    device="cuda")
                kc[:, held % window] = k[:, held]
                vc[:, held % window] = v[:, held]
            ka, va, off = Cm.flash_decode_layout(kc, vc, pos, window)

            def step(qq, kk, vv):
                return Cm.flash_decode_attention(qq, kk, vv, pos,
                                                 window=window)
        got = step(qd, kc, vc)
        lin_off = torch.full((B,), pos if causal else 0, dtype=torch.int32,
                             device="cuda")
        lin_err, lin_ok = max_err(got, fa.flash_attention_plain(
            qd, k, v, q_offset=lin_off, causal=causal, window=window))
        checks = {"row_of_whole_call": torch.equal(got[:, 0], whole[:, pos]),
                  "row_alone": torch.equal(step(qd[1:2], kc[1:2], vc[1:2]),
                                           got[1:2])}
        if not lin_ok:
            fail(f"flash_attention [{case}]: the decode row is {lin_err} "
                 "from the plain version over the linear history")
        offs = torch.full((B,), int(off), dtype=torch.int32, device="cuda")
        flash(case, qd, ka.contiguous(), va.contiguous(), offs, causal,
              window, bitwise=all(checks.values()), pos=pos,
              cache_slots=kc.shape[1], plain_linear_max_abs_err=lin_err,
              **checks)

    def prefill_qkv(g, H, KVH, Dh):
        q = torch.randn(2, 512, H, Dh, generator=g, device="cuda").bfloat16()
        k = torch.randn(2, 512, KVH, Dh, generator=g, device="cuda").bfloat16()
        v = torch.randn(2, 512, KVH, Dh, generator=g, device="cuda").bfloat16()
        return q, k, v, torch.zeros(2, dtype=torch.int32, device="cuda")

    # paged attention: decode (T=1) and verify (T=5 = spec_k + 1) at the
    # serve phase's contexts, verify at ~2,000-key contexts (a pool of
    # 1,040 pages of 16 and the null page), and Dh 64 with 4 query heads
    # per kv head (T * G = 20 rows: two row groups)
    short = [255, 17, 283, 100, 31, 200, 64, 129]
    long_ = [2040, 1800, 1999, 1024, 2047, 1500, 1900, 1700]
    for case, T, lengths, P, seed, shape in (
            ("B8_T1", 1, short, 154, 1, {}),
            ("B8_T5", 5, short, 154, 5, {}),
            ("B8_T5_long", 5, long_, 1041, 6, {}),
            ("B4_T5_G4_dh64", 5, [300, 5, 130, 64], 154, 7,
             {"H": 16, "KVH": 4, "Dh": 64})):
        paged(case, T, lengths, P, seed, shape)
    contiguous("qwen3_G2_dh128", 11)

    # flash attention: whole 512-token causal prefill, and one fused
    # chunk step (B 8 x C 32, per-row offsets, ragged gathered buffer)
    g = torch.Generator(device="cuda").manual_seed(7)
    H, KVH, Dh = 16, 8, 128
    flash("prefill_B2_S512", *prefill_qkv(g, H, KVH, Dh))
    starts = [0, 32, 64, 96, 128, 160, 192, 224]
    skv = 16 * 16 + 32                       # bucket 16 pages + chunk
    q = torch.randn(8, 32, H, Dh, generator=g, device="cuda").bfloat16()
    k = torch.randn(8, skv, KVH, Dh, generator=g, device="cuda").bfloat16()
    v = torch.randn(8, skv, KVH, Dh, generator=g, device="cuda").bfloat16()
    off = torch.tensor(starts, dtype=torch.int32, device="cuda")
    flash("chunk_B8_C32", q, k, v, off)

    # the other served architectures' attention shapes: G = H / KVH of 7
    # and 5 puts two tokens' rows into one 16-row group of the paged
    # kernel; G 1 with 32 KV heads gives 256 row groups of one live row
    for i, (label, (H, KVH, Dh)) in enumerate(ATTN_SHAPES.items()):
        shape = {"H": H, "KVH": KVH, "Dh": Dh}
        for T in (1, 5):
            paged(f"B8_T{T}_{label}", T, short, 154, 30 + 2 * i + T, shape)
        contiguous(label, 40 + i, **shape)
        flash(f"prefill_B2_S512_{label}", *prefill_qkv(g, H, KVH, Dh))

    # the families' new cases.  recurrentgemma: a 2,048-token prefill
    # under its 2,048-key window at Dh 256 (G 10), and its decode over
    # the ring (the contiguous cache of 2,048 slots viewed as one page a
    # row, every slot written); whisper-tiny: the encoder's attention
    # over 1,500 frames and the decoder's cross-attention of a 64-token
    # prompt over them, without a causal mask
    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").bfloat16()

    (H, KVH), Dh, W = RG_HEADS, RG_DH, RG_WINDOW
    zeros2 = torch.zeros(2, dtype=torch.int32, device="cuda")
    flash(f"prefill_B2_S{W}_window{W}_dh{Dh}", rnd(2, W, H, Dh),
          rnd(2, W, KVH, Dh), rnd(2, W, KVH, Dh), zeros2, window=W)
    ring = {"H": H, "KVH": KVH, "Dh": Dh}
    args = (rnd(8, 1, H, Dh), rnd(8, W, KVH, Dh), rnd(8, W, KVH, Dh),
            torch.arange(8, dtype=torch.int32, device="cuda")[:, None],
            torch.full((8,), W - 1, dtype=torch.int32, device="cuda"))
    ring_case(f"B8_T1_ring{W}_dh{Dh}", args, ring)
    H, Dh, F_ = WHISPER_HEADS, WHISPER_DH, WHISPER_FRAMES
    zeros8 = torch.zeros(8, dtype=torch.int32, device="cuda")
    k, v = rnd(8, F_, H, Dh), rnd(8, F_, H, Dh)
    flash(f"encoder_B8_S{F_}_dh{Dh}", rnd(8, F_, H, Dh), k, v, zeros8,
          causal=False)
    q64 = rnd(8, 64, H, Dh)
    flash(f"cross_B8_Sq64_Skv{F_}_dh{Dh}", q64, k, v, zeros8, causal=False)

    # the families' decode rows (B 8, Sq 1) as their decode steps run
    # them: deepseek G 1 and qwen2-vl G 7 at Dh 128 and whisper's
    # self-attention at the last step's position (prompt + GEN - 2) over
    # a cache of prompt + GEN slots; recurrentgemma's 2,048-slot ring at
    # the last step's position and at one whose window starts in the
    # third key tile; whisper's cross-attention of one row over the
    # 1,500 frames
    prompts = dict(FAMILIES_ON_CARD)
    for label, (H, KVH, Dh), arch in (
            ("deepseek_G1_dh128", ATTN_SHAPES["deepseek_G1_dh128"],
             "deepseek-moe-16b"),
            ("qwen2vl_G7_dh128", ATTN_SHAPES["qwen2vl_G7_dh128"],
             "qwen2-vl-7b"),
            ("whisper_self_G1_dh64", (WHISPER_HEADS, WHISPER_HEADS,
                                      WHISPER_DH), "whisper-tiny")):
        pos = prompts[arch] + GEN - 2
        decode_row(f"decode_B8_{label}_pos{pos}", rnd(8, pos + 1, H, Dh),
                   rnd(8, pos + 1, KVH, Dh), rnd(8, pos + 1, KVH, Dh), pos,
                   s_max=prompts[arch] + GEN)
    (H, KVH), Dh = RG_HEADS, RG_DH
    for pos in (W + GEN - 2, W + 2 * 64 + 24):
        decode_row(f"decode_B8_ring{W}_dh{Dh}_pos{pos}",
                   rnd(8, pos + 1, H, Dh), rnd(8, pos + 1, KVH, Dh),
                   rnd(8, pos + 1, KVH, Dh), pos, window=W)
    H, Dh = WHISPER_HEADS, WHISPER_DH
    decode_row(f"decode_cross_B8_Skv{F_}_dh{Dh}", q64, k, v, 63,
               causal=False)

    # the training path: the attention backward and the projections'
    # backward products
    _flash_bwd_cases(g, flush, results)
    _gemm_bwd_cases(g, flush, results)
    _gemm_bwd_f32_cases(g, flush, results)
    del flush
    if torch.cuda.device_count() > 1:
        rec = _every_card(torch.cuda.device_count())
        emit(rec)
        if not rec["ok"]:
            fail(f"kernels: a kernel failed on a card other than the "
                 f"first: {rec['by_card']}")
    return results


def _lut_x(g, rows, cols, scale):
    """Activations of the given shape: normal values times ``scale``,
    with every fourth value an exact half step LUT_LO + (i + 0.5) STEP
    (where rounding half to even decides the entry) and +-inf, |x| > 8
    and the grid's ends among the first eight."""
    import torch
    from repro_torch.kernels.lut_activation import LUT_ENTRIES, LUT_LO, STEP
    n = rows * cols
    x = torch.randn(n, generator=g, device="cuda") * scale
    idx = torch.randint(0, LUT_ENTRIES, (n,), generator=g, device="cuda")
    x[::4] = LUT_LO + (idx[::4].float() + 0.5) * STEP
    x[:8] = torch.tensor([float("inf"), float("-inf"), 8.5, -8.5, 1e30,
                          -1e30, 7.9999, -8.0], device="cuda")
    return x.reshape(rows, cols)


def _scout_masks(b):
    """(case, mask, B) for the block-sparse GEMM on scout's operands:
    masks at the Table-3 keep rates, made as
    benchmarks/kernel_dataflow.py makes them, and one read by
    ``mask_from_weights`` from a B whose pruned tiles are zero (keep
    0.36 at random, every eighth column of tiles pruned whole, so some
    output columns are dead)."""
    import torch
    from repro_torch.kernels import block_sparse as bs
    nk, nn = SCOUT_K // 128, SCOUT_N // 128
    out = []
    for keep in KEEP_RATES:
        rng = np.random.default_rng(int(keep * 100))
        out.append((f"keep_{keep}", rng.random((nk, nn)) < keep, b))
    keep = np.random.default_rng(1).random((nk, nn)) < 0.36
    keep[:, 7::8] = False
    pruned = b * torch.from_numpy(bs.expand_mask(keep, 128, 128)).to(b.device)
    mask = bs.mask_from_weights(pruned.float().cpu().numpy(), 128, 128)
    if not np.array_equal(mask, keep):
        fail("paper: mask_from_weights did not recover the pruned tiles")
    out.append(("from_weights", mask, pruned))
    return out


def phase_paper():
    """The paper's kernel path at full width: the dataflow GEMM, the
    block-sparse GEMM and the LUT activation through their entry points.
    Returns ({kernel: [case records]}, {kernel: launches on the path})."""
    import torch
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels import gemm_dataflow as gd
    from repro_torch.kernels import lut_activation as lut
    from repro_torch.kernels.block_sparse import ops as bs_ops
    from repro_torch.kernels.gemm_dataflow import ops as gd_ops
    from repro_torch.kernels.lut_activation import ops as lut_ops
    t_phase = time.perf_counter()
    M, K, N = SCOUT_M, SCOUT_K, SCOUT_N
    g = torch.Generator(device="cuda").manual_seed(12)
    a = torch.randn(M, K, generator=g, device="cuda").bfloat16()
    b = torch.randn(K, N, generator=g, device="cuda").bfloat16()
    a2 = torch.randn(2 * M, K, generator=g, device="cuda").bfloat16()
    b2 = torch.randn(K, 2 * N, generator=g, device="cuda").bfloat16()
    a32 = torch.randn(1000, K, generator=g, device="cuda")
    b32 = torch.randn(K, 1000, generator=g, device="cuda")
    # ragged bf16: K and N no multiple of 8 (element-wise loads), N odd
    ar = torch.randn(1000, 5100, generator=g, device="cuda").bfloat16()
    br = torch.randn(5100, 999, generator=g, device="cuda").bfloat16()
    mask_r = np.random.default_rng(2).random((40, 8)) < 0.36
    mask_r[:, 3] = False
    sparse_cases = ([(case, a, w, mask) for case, mask, w in _scout_masks(b)]
                    + [("ragged_bf16", ar, br, mask_r)])
    x_act = _lut_x(g, M, N, 2.0)           # the GEMM's output shape
    x_tab = _lut_x(g, 2048, 2048, 3.0)
    D = gd.Dataflow
    # input-/weight-stationary parallelise over M/128 or N/128 blocks
    # only (64 here, on 132 SMs); the 2M / 2N cases give them 128
    gemm_cases = ([("scout_expert_bf16", df, a, b) for df in D]
                  + [("scout_2m_bf16", df, a2, b)
                     for df in (D.OUTPUT_STATIONARY, D.INPUT_STATIONARY)]
                  + [("scout_2n_bf16", df, a, b2)
                     for df in (D.OUTPUT_STATIONARY, D.WEIGHT_STATIONARY)]
                  + [("ragged_f32", df, a32, b32) for df in D]
                  + [("ragged_bf16", df, ar, br) for df in D])
    lut_cases = ([("silu_f32", "silu", x_act),
                  ("silu_bf16", "silu", x_act.bfloat16())]
                 + [(f"{name}_f32", name, x_tab)
                    for name in sorted(lut.TABLES)])

    # the path: each entry point once per case, counters from 0
    gd_ops.launches = gd_ops.launches_f32 = 0
    bs_ops.launches = lut_ops.launches = 0
    gemm_out = [gd.matmul(x, w, df) for _, df, x, w in gemm_cases]
    bs_out = [bs.matmul(x, w, mask) for _, x, w, mask in sparse_cases]
    lut_out = [lut.apply_lut(x, name) for _, name, x in lut_cases]
    torch.cuda.synchronize()
    launches = {"gemm_dataflow": gd_ops.launches,
                "gemm_dataflow_f32": gd_ops.launches_f32,
                "block_sparse": bs_ops.launches,
                "lut_activation": lut_ops.launches}
    want = {"gemm_dataflow": len(gemm_cases),
            "gemm_dataflow_f32": sum(x.dtype == torch.float32
                                     for _, _, x, _ in gemm_cases),
            "block_sparse": len(sparse_cases),
            "lut_activation": len(lut_cases)}
    if launches != want:
        fail(f"paper: launches {launches}, the path needs {want}")

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    results = {}

    def record(kernel, case, got, want, atol, rtol, t_k, t_p, t_l,
               n_bytes, flops, flops_per_s, **extra):
        err, ok = max_err(got, want, atol, rtol)
        b_ms, b_by = bound_ms(n_bytes, flops, flops_per_s)
        rec = {"phase": "paper", "kernel": kernel, "case": case, **extra,
               "max_abs_err": err, "atol": atol, "rtol": rtol, "ok": ok,
               "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
               "flops": flops, "launches": launches[kernel]}
        emit(rec)
        if not ok:
            fail(f"{kernel} [{case}] disagrees with its plain version: "
                 f"max abs err {err} (atol {atol}, rtol {rtol})")
        results.setdefault(kernel, []).append(rec)

    # dataflow GEMM: every dataflow of a case gives the first one's bits
    first = {}
    for (case, df, x, w), got in zip(gemm_cases, gemm_out):
        if case not in first:
            first[case] = (got, gd.matmul_plain(x, w),
                           time_ms(lambda: gd.matmul_plain(x, w), iters=3,
                                   flush=flush),
                           time_ms(lambda: torch.matmul(x, w), flush=flush))
        ref_c, want_c, t_p, t_l = first[case]
        same = torch.equal(got, ref_c)
        if not same:
            fail(f"gemm_dataflow [{case}]: {df.value} gives other bits "
                 "than output_stationary")
        m, k = x.shape
        n = w.shape[1]
        e = x.element_size()
        t_k = time_ms(lambda: gd.matmul(x, w, df), flush=flush,
                      budget_ms=1500)
        record("gemm_dataflow", case, got, want_c, GEMM_ATOL, GEMM_RTOL,
               t_k, t_p, t_l, (m * k + k * n) * e + m * n * 4,
               2 * m * n * k,
               BF16_FLOPS_PER_S if e == 2 else F32_FLOPS_PER_S,
               dataflow=df.value, M=m, K=k, N=n, dtype=str(x.dtype)[6:],
               bitwise_equal_across_dataflows=same,
               modeled_bytes=gd.modeled_traffic(
                   m, n, k, df, bytes_per_elem=e)["total_bytes"])
    del first

    # block-sparse GEMM: live tiles only; dead columns exactly 0
    for (case, x, w, mask), got in zip(sparse_cases, bs_out):
        m, k = x.shape
        n = w.shape[1]
        live_w = bs.expand_mask(mask, 128, 128)[:k, :n]   # live weights
        dead = torch.from_numpy(~live_w.any(axis=0)).cuda()
        dead_zero = bool((got[:, dead] == 0).all())
        if not dead_zero:
            fail(f"block_sparse [{case}]: a dead column is not 0")
        dense = w * torch.from_numpy(live_w).cuda()
        n_live, k_live = int(live_w.sum()), int(live_w.any(axis=1).sum())
        record("block_sparse", case, got, bs.matmul_plain(x, w, mask),
               GEMM_ATOL, GEMM_RTOL,
               time_ms(lambda: bs.matmul(x, w, mask), flush=flush,
                       budget_ms=1000),
               time_ms(lambda: bs.matmul_plain(x, w, mask), iters=3,
                       flush=flush),
               time_ms(lambda: torch.matmul(x, dense), flush=flush),
               (m * k_live + n_live) * 2 + m * n * 4, 2 * m * n_live,
               BF16_FLOPS_PER_S, M=m, K=k, N=n, dtype="bfloat16",
               tiles_live=int(mask.sum()), tiles_total=int(mask.size),
               dead_columns=int((~mask.any(axis=0)).sum()),
               dead_columns_zero=dead_zero)
        del dense
    # the two producers of the bf16 pipeline on the same aligned
    # operands: the same C, through the wrappers' private launchers
    if gd_ops.producer_for(a, b) != gd_ops.TMA:
        fail("paper: the scout operands should take the TMA producer")
    OS = D.OUTPUT_STATIONARY
    cp_c = gd_ops._launch(a, b, OS, gd_ops.CP_ASYNC)
    mask0 = sparse_cases[0][3]
    cp_bs = bs_ops._launch(a, b, mask0, gd_ops.CP_ASYNC)
    same_gemm = torch.equal(cp_c, gemm_out[0])
    same_bs = torch.equal(cp_bs, bs_out[0])
    emit({"phase": "paper", "check": "producers", "case": "scout_expert_bf16",
          "gemm_tma_equals_cp_async": same_gemm,
          "block_sparse_tma_equals_cp_async": same_bs,
          "gemm_os_tma_ms": time_ms(lambda: gd_ops._launch(
              a, b, OS, gd_ops.TMA), flush=flush),
          "gemm_os_cp_async_ms": time_ms(lambda: gd_ops._launch(
              a, b, OS, gd_ops.CP_ASYNC), flush=flush),
          "ragged_bf16_producer": "cp_async" if gd_ops.producer_for(
              ar, br) == gd_ops.CP_ASYNC else "tma"})
    if not (same_gemm and same_bs):
        fail(f"paper: the cp.async producer gives other bits than TMA "
             f"(gemm {same_gemm}, block-sparse {same_bs})")
    del cp_c, cp_bs
    nk, nn = K // 128, N // 128
    dense_bits = torch.equal(bs.matmul(a, b, np.ones((nk, nn), bool)),
                             gemm_out[0])
    empty_zero = bool((bs.matmul(a, b, np.zeros((nk, nn), bool)) == 0
                       ).all())
    if not (dense_bits and empty_zero):
        fail(f"block_sparse: density 1 == output-stationary bits "
             f"{dense_bits}, fully pruned == 0 {empty_zero}")

    # LUT activation: bit-identical to the plain version.  The library
    # yardstick is the table's function called on x; for bf16 x it
    # would return bf16, not the kernel's f32, so there is none.
    for (case, name, x), got in zip(lut_cases, lut_out):
        table = lut.table_for(name, str(x.device))
        n = x.numel()
        t_l, note = None, ("no single PyTorch call maps bf16 x to f32 "
                           f"{name}(x)")
        if x.dtype == torch.float32:
            t_l = time_ms(lambda: lut.TABLES[name](x), flush=flush)
            note = f"lut.TABLES['{name}'](x)"
        record("lut_activation", case, got, lut.lut_plain(x, table), 0.0,
               0.0, time_ms(lambda: lut.apply_lut(x, name), flush=flush),
               time_ms(lambda: lut.lut_plain(x, table), iters=5,
                       flush=flush),
               t_l, n * x.element_size() + n * 4 + lut.LUT_ENTRIES * 4, 0,
               BF16_FLOPS_PER_S, table=name, shape=list(x.shape),
               dtype=str(x.dtype)[6:], library=note)
    # the kernel's scalar paths, bit for bit: a tail of 7 values (n =
    # 1001 * 999) and x at an address no multiple of 16 bytes (a view
    # from element 1), in f32 and bf16
    edges = {}
    silu = lut.table_for("silu", "cuda")
    x_edge = _lut_x(g, 1001, 999, 3.0)
    for dt in (torch.float32, torch.bfloat16):
        xe = x_edge.to(dt)
        for label, xx in (("tail", xe), ("unaligned", xe.reshape(-1)[1:])):
            edges[f"{label}_{str(dt)[6:]}"] = torch.equal(
                lut.lut_activation(xx, silu), lut.lut_plain(xx, silu))
    emit({"phase": "paper", "check": "lut_scalar_paths", **edges})
    if not all(edges.values()):
        fail(f"lut_activation: a scalar path differs from the plain version "
             f"{edges}")
    # what the table gathers cost: the same kernel on the same shapes
    # with every x equal (one table entry), beside the silu cases
    probe = {"phase": "paper", "check": "lut_gather_probe",
             "shape": [M, N], "x": 0.5}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.full((M, N), 0.5, dtype=dt, device="cuda")
        ms = time_ms(lambda: lut.apply_lut(x, "silu"), flush=flush)
        probe[f"constant_index_{str(dt)[6:]}_ms"] = ms
    del x
    emit(probe)
    _projection_cases(g, flush, record)
    _f32_cases(g, flush, record)
    del flush
    emit({"phase": "paper", "seconds": time.perf_counter() - t_phase,
          "launches": launches,
          "block_sparse_density_1_equals_output_stationary": dense_bits,
          "block_sparse_fully_pruned_is_zero": empty_zero})
    return results, launches


#: the kernels of the serving path, whose launches the main-path runs
#: count (the attention kernels and, since the projections moved onto
#: it, the dataflow GEMM)
PATH_KERNELS = ("flash_attention", "paged_attention", "gemm_dataflow")
#: what ``_launches_read`` returns: those kernels' counts, and the
#: dataflow GEMM's f32 launches among its own
PATH_COUNTERS = PATH_KERNELS + ("gemm_dataflow_f32",)


def _ops(name):
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{name}.ops")


def _projection_cases(g, flush, record) -> None:
    """The dataflow GEMM as the serving path calls it: a projection
    ``components.linear(x, W)`` of PROJ_ROWS rows, bf16, at PROJ_SHAPES;
    the kernel (f32 out) against its plain version, ``torch.matmul``
    (bf16 out, what a library projection returns) and the byte /
    operation bound, with the producer it took and whether the first M
    rows of a 2,048-row call give the bits of an M-row call (gated)."""
    import torch
    from repro_torch.kernels import gemm_dataflow as gd
    from repro_torch.kernels.gemm_dataflow import ops as gd_ops
    from repro_torch.models import components as C
    for label, (K, N) in PROJ_SHAPES.items():
        w = torch.randn(K, N, generator=g, device="cuda").bfloat16()
        big = torch.randn(max(PROJ_ROWS), K, generator=g,
                          device="cuda").bfloat16()
        full = C.linear(big, w)
        for M in PROJ_ROWS:
            x = big[:M]
            stable = torch.equal(C.linear(x, w), full[:M])
            if not stable:
                fail(f"gemm_dataflow [{label}, M {M}]: a row's bits depend "
                     "on the row count of its call")
            t_k = time_ms(lambda: gd.matmul(x, w), flush=flush)
            t_l = time_ms(lambda: torch.matmul(x, w), flush=flush)
            record("gemm_dataflow", f"proj_{label}_M{M}", gd.matmul(x, w),
                   gd.matmul_plain(x, w), GEMM_ATOL, GEMM_RTOL, t_k,
                   time_ms(lambda: gd.matmul_plain(x, w), iters=3,
                           flush=flush),
                   t_l, (M * K + K * N) * 2 + M * N * 4, 2 * M * N * K,
                   BF16_FLOPS_PER_S, dataflow="output_stationary", M=M, K=K,
                   N=N, dtype="bfloat16",
                   producer=("tma" if gd_ops.producer_for(x, w) == gd_ops.TMA
                             else "cp_async"),
                   linear_ms=time_ms(lambda: C.linear(x, w), flush=flush),
                   rows_stable_vs_2048=stable,
                   kernel_over_library=t_k / t_l)


def _f32_cases(g, flush, record) -> None:
    """The dataflow GEMM on the products whose weight enters in f32
    (F32_SHAPES), output-stationary as ``components.linear`` runs them:
    against its plain version, ``torch.matmul`` in f32 (``allow_tf32``
    off) and the byte / FFMA bound; gated on the NO_REUSE kernel's bits
    (``torch.equal``: NO_REUSE keeps the FMA tile product of
    tile_mma.cuh) and on the first M rows of the largest call giving
    the bits of an M-row call."""
    import torch
    from repro_torch.kernels import gemm_dataflow as gd
    from repro_torch.kernels.gemm_dataflow import ops as gd_ops
    NR = gd.Dataflow.NO_REUSE
    for label, (K, N, rows) in F32_SHAPES.items():
        w = torch.randn(K, N, generator=g, device="cuda")
        big = torch.randn(max(rows), K, generator=g, device="cuda")
        full = gd.matmul(big, w)
        for M in rows:
            x = big[:M]
            got = gd.matmul(x, w)
            equal_nr = torch.equal(got, gd.matmul(x, w, NR))
            stable = torch.equal(got, full[:M])
            if not (equal_nr and stable):
                fail(f"gemm_dataflow [f32 {label}, M {M}]: equal to "
                     f"no_reuse {equal_nr}, rows stable against M "
                     f"{max(rows)} {stable}")
            t_k = time_ms(lambda: gd.matmul(x, w), flush=flush,
                          budget_ms=1000)
            t_l = time_ms(lambda: torch.matmul(x, w), flush=flush,
                          budget_ms=1000)
            dev_k = device_ms(lambda: gd.matmul(x, w))
            dev_l = device_ms(lambda: torch.matmul(x, w))
            record("gemm_dataflow", f"f32_{label}_M{M}", got,
                   gd.matmul_plain(x, w), GEMM_ATOL, GEMM_RTOL, t_k,
                   time_ms(lambda: gd.matmul_plain(x, w), iters=3,
                           flush=flush),
                   t_l, (M * K + K * N) * 4 + M * N * 4, 2 * M * N * K,
                   F32_FLOPS_PER_S, dataflow="output_stationary", M=M, K=K,
                   N=N, dtype="float32",
                   plan=list(gd_ops.plan_f32(M, N, K, gd_ops._sm_count(
                       x.device))[:4]),
                   equals_no_reuse=equal_nr, rows_stable_vs_largest=stable,
                   kernel_over_library=t_k / t_l, device_ms=dev_k,
                   library_device_ms=dev_l,
                   device_kernel_over_library=dev_k / dev_l)
        del w, big, full


def _launches_reset() -> None:
    for name in PATH_KERNELS:
        _ops(name).launches = 0
    _ops("gemm_dataflow").launches_f32 = 0


def _launches_read() -> dict:
    """The path kernels' launches, and the dataflow GEMM's f32 ones
    among them (``gemm_dataflow_f32``)."""
    counts = {name: _ops(name).launches for name in PATH_KERNELS}
    counts["gemm_dataflow_f32"] = _ops("gemm_dataflow").launches_f32
    return counts


def _n_products(model, *, decode: bool = False) -> int:
    """The ``components.linear`` calls of one forward of ``model`` over
    its layers: every 2D projection of every layer (routers and the f32
    products included, the MoE experts' batched weights and the
    embedding not), RWKV6's token-mix map as its 5 slices.  With
    ``decode``, a whisper decode step's (the encoder and the cross
    K/V run once, at prefill)."""
    from repro_torch.models.base import flatten_specs
    n = 0
    for path, spec in flatten_specs(model.param_specs()):
        shape, name = spec.init_shape, path[-1]
        if (path[0] == "embed" or name in ("conv_w", "u", "ln_x_scale",
                                           "ln_x_bias")):
            continue
        if decode and (path[0].startswith("enc_") or (
                path[1:2] == ("cross_attn",) and name in ("wk", "wv"))):
            continue
        stacked = path[0] == "layers"
        per_layer = shape[1:] if stacked else shape
        count = shape[0] if stacked else 1
        if name == "tm_w2":
            n += 5 * count
        elif len(per_layer) == 2:
            n += count
    return n


def _n_dead(model) -> int:
    """The products of one training forward whose output the backward
    never reads: a block's last product where nothing after it saves
    it (the dense FFN's down projection ``wd`` / ``w2``, the shared
    expert's ``wd``; not the routed experts' or RWKV6's channel mix's),
    which the recompute under remat skips (``components.remat``)."""
    from repro_torch.models.base import flatten_specs
    n = 0
    for path, spec in flatten_specs(model.param_specs()):
        shape = spec.init_shape
        stacked = path[0] == "layers"
        per_layer = shape[1:] if stacked else shape
        if (path[-1] in ("wd", "w2") and path[-2] in ("ffn", "mlp", "shared")
                and len(per_layer) == 2):
            n += shape[0] if stacked else 1
    return n


def _launch_gates(model, st) -> dict:
    """What the serving engine's dispatches (folded counters ``st``)
    must have launched at the least: flash once a layer for each
    prefill dispatch, paged once a layer for each decode or replay
    step, the dataflow GEMM once a projection for each dispatch."""
    L = model.cfg.n_layers
    return {"flash_attention": L * int(st["n_prefill_dispatches"]),
            "paged_attention": L * int(st["n_decode_steps"]
                                       + st["n_replay_steps"]),
            "gemm_dataflow": _n_products(model)
            * int(st["n_total_dispatches"])}


def phase_serve():
    """qwen3-0.6b FULL, seeded random init, 16 requests through the
    engine with the ServeOptions defaults at batch 8.  Returns what the
    parity phase and the summary need."""
    import torch
    from repro_torch import configs
    from repro_torch.launch.serve import serve_trace, synth_requests
    from repro_torch.models.lm import DecoderLM
    from repro_torch.serve import ServeOptions, ServePrograms
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    cfg = configs.get("qwen3-0.6b")
    model = DecoderLM(cfg)                       # the GPU
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    programs = ServePrograms(model)
    opts = ServeOptions(batch=8)
    # warm-up: cuBLAS handles, allocator pools, the kernels' first loads
    warm = synth_requests(cfg, 2, PROMPT_LEN, 4, rate=50.0, seed=1)
    opts.sized_for(warm).build(model, params, programs=programs).run(warm)
    torch.cuda.synchronize()

    def trace():
        return synth_requests(cfg, N_REQUESTS, PROMPT_LEN, GEN, rate=50.0)
    reqs = trace()
    opts = opts.sized_for(reqs)
    engine = opts.build(model, params, programs=programs)
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9
    _launches_reset()
    stats = serve_trace(engine, reqs, realtime=True)
    launches = _launches_read()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    graphs_held = engine.compiled.graphs()
    want = _launch_gates(model, stats)
    bitwise = _bitwise_invariants(model, params, seed=8)
    row_bits = _row_bits(model, programs.prepare_params(params))
    # the same trace eagerly (a reading beside the graphed run's)
    eager = opts.build(model, params,
                       programs=ServePrograms(model, graphs=False))
    torch.cuda.reset_peak_memory_stats()
    e_start_gb = torch.cuda.memory_allocated() / 1e9
    e_stats = serve_trace(eager, trace(), realtime=True)
    e_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del eager
    graph_gate = _graph_gate(cfg.name, model, programs.prepare_params(params),
                             programs, opts, trace, seed=10)
    reading = {"arch": cfg.name, "graphs_held": graphs_held,
               "tok_per_s": {"graphs": stats["tok_per_s"],
                             "eager": e_stats["tok_per_s"]},
               "ttft_mean_s": {"graphs": stats["ttft_mean_s"],
                               "eager": e_stats["ttft_mean_s"]},
               "wall_s": {"graphs": stats["wall_s"],
                          "eager": e_stats["wall_s"]},
               # each run's peak above what was allocated as it began
               # (the graphed engine's graphs, pool and static buffers
               # against the eager run's transients)
               "run_peak_gb": {"graphs": peak_gb - start_gb,
                               "eager": e_peak_gb - e_start_gb},
               "extra_peak_gb": (peak_gb - start_gb) - (e_peak_gb
                                                        - e_start_gb),
               "serve_trace_graph_stats": programs.graph_stats.as_dict()}
    emit({"phase": "serve", "arch": cfg.name, "n_params": n_params,
          "init_s": init_s, "requests": stats["requests"],
          "prompt_len": PROMPT_LEN, "gen": GEN, "batch": opts.batch,
          "page_size": opts.page_size, "chunk_size": opts.chunk_size,
          "spec_k": opts.spec_k, "fused": opts.fused,
          "n_pages": opts.n_pages,
          "kv_pool_gb": 2 * engine.cache.k_pages.numel() * 2 / 1e9,
          "tokens": stats["tokens"], "wall_s": stats["wall_s"],
          "tok_per_s": stats["tok_per_s"],
          "ttft_mean_s": stats["ttft_mean_s"],
          "peak_mem_gb": peak_gb,
          "counters": {k: v for k, v in stats.items()
                       if k.startswith("n_") or k == "accept_rate"},
          "launches": launches, "launches_expected": want,
          "bitwise": bitwise, "row_bits": row_bits,
          "graph_equals_eager": graph_gate,
          "seconds": time.perf_counter() - t_phase,
          "card": nvidia_smi_line()})
    done = sorted(engine.finished, key=lambda r: r.rid)
    if len(done) != N_REQUESTS or any(len(r.generated) != GEN
                                      for r in done):
        fail(f"serve: {len(done)} requests finished, generated "
             f"{[len(r.generated) for r in done]} tokens")
    for name, n in want.items():
        if launches[name] < n or launches[name] == 0:
            fail(f"serve: {name} launched {launches[name]} times, the "
                 f"path's dispatches need {n}")
    if not _bitwise_held(bitwise):
        fail(f"serve: a model-level bitwise invariant failed: {bitwise}")
    _row_bits_gate("serve", row_bits)
    return model, params, programs, done, launches, reading


def _bitwise_invariants(model, params, *, seed) -> dict:
    """The engine's bitwise invariants at the model level, on full-width
    logits (``torch.equal``), for 8 prompts of BITWISE_LENS tokens:

    * chunked == whole: each prompt fed as BITWISE_CHUNK-token
      ``prefill_chunk_paged`` chunks gives the last-token logits (and
      the K/V pages) of the same prompts as one chunk;
    * verify at T = 1 == decode: ``verify_step_paged`` of each row's
      next token == ``decode_step_paged`` of it, from the same pages;
    * fused == unfused: ``fused_step_paged`` of those 8 rows verifying 5
      tokens each and 8 new prompts ingesting a first chunk gives the
      logits and pages of ``prefill_chunk_paged`` then
      ``verify_step_paged`` run alone.

    Returns each invariant's verdict and, where it fails, the largest
    logit difference."""
    import torch
    cfg, dev = model.cfg, model.device
    B, C, ps = len(BITWISE_LENS), BITWISE_CHUNK, 16
    S = max(BITWISE_LENS)
    rng = np.random.default_rng(seed)
    i32 = dict(dtype=torch.int32, device=dev)
    prompts = torch.tensor(rng.integers(0, cfg.vocab_size, (2 * B, S)), **i32)
    lens = torch.tensor(BITWISE_LENS, **i32)
    per_row = -(-(S + 8) // ps)
    tables = torch.arange(2 * B * per_row, **i32).reshape(2 * B, per_row) + 1
    shape = (cfg.n_layers, 1 + 2 * B * per_row, ps, cfg.n_kv_heads,
             cfg.head_dim)

    def fresh():
        return {n: torch.zeros(shape, dtype=torch.bfloat16, device=dev)
                for n in ("k_pages", "v_pages")} | {
            "page_tables": tables[:B].clone(), "lengths": lens.clone()}

    def clone(st):
        return {k: v.clone() for k, v in st.items()}

    def verdict(a, b):
        same = torch.equal(a, b)
        return same, (None if same else float((a - b).abs().max()))

    out = {}
    with torch.no_grad():
        zeros = torch.zeros(B, **i32)
        whole, st_w = model.prefill_chunk_paged(
            params, fresh(), prompts[:B], tables[:B], zeros, lens)
        st_c = fresh()
        chunked = torch.empty_like(whole)
        for s in range(0, S, C):
            nv = torch.clamp(lens - s, 0, C)
            logits, st_c = model.prefill_chunk_paged(
                params, st_c, prompts[:B, s:s + C].contiguous(),
                tables[:B, :-(-(s + C) // ps)].contiguous(),
                torch.full((B,), s, **i32), nv)
            done = (lens > s) & (lens <= s + C)
            chunked[done] = logits[done]
        out["chunked_equals_whole"], out["chunked_max_diff"] = verdict(
            chunked, whole)
        out["chunked_kv_equals_whole"] = all(
            torch.equal(st_c[n][:, 1:], st_w[n][:, 1:])
            for n in ("k_pages", "v_pages"))

        nxt = whole.argmax(-1).to(torch.int32)[:, None]
        dec, _ = model.decode_step_paged(params, clone(st_w), nxt)
        ver, _ = model.verify_step_paged(params, clone(st_w), nxt)
        out["verify_t1_equals_decode"], out["verify_t1_max_diff"] = verdict(
            ver[:, 0], dec)

        d_tok = torch.cat([nxt, torch.tensor(
            rng.integers(0, cfg.vocab_size, (B, 4)), **i32)], 1)
        p_tok = prompts[B:, :C].contiguous()
        p_rows = tables[B:, :-(-C // ps)].contiguous()
        p_nv = torch.tensor(rng.integers(1, C + 1, B), **i32)
        (fd, fp), st_f = model.fused_step_paged(
            params, clone(st_w), d_tok, p_tok, p_rows, zeros, p_nv)
        p_alone, st_u = model.prefill_chunk_paged(
            params, clone(st_w), p_tok, p_rows, zeros, p_nv)
        d_alone, st_u = model.verify_step_paged(params, st_u, d_tok)
        d_same, d_diff = verdict(fd, d_alone)
        p_same, p_diff = verdict(fp, p_alone)
        kv_same = all(torch.equal(st_f[n][:, 1:], st_u[n][:, 1:])
                      for n in ("k_pages", "v_pages"))
        out["fused_equals_unfused"] = d_same and p_same and kv_same
        out["fused_max_diff"] = {"decode": d_diff, "prefill": p_diff,
                                 "kv_equal": kv_same}
    out.update(lengths=list(BITWISE_LENS), chunk=C, page_size=ps,
               verify_tokens=int(d_tok.shape[1]), seed=seed)
    return out


def _bitwise_held(bw: dict) -> bool:
    return (bw["chunked_equals_whole"] and bw["chunked_kv_equals_whole"]
            and bw["verify_t1_equals_decode"] and bw["fused_equals_unfused"])


def _graph_logits(model, params, *, seed) -> dict:
    """One dispatch of each paged program through a CUDA graph
    (``compiled.CompiledProgram`` over the model's logits-returning
    method, the engine's own programs but for the argmax), replayed on
    other tokens, valid counts and lengths than its capture's first
    call, against the eager method on the replay's inputs from the same
    pools: the logits read from the graph's static output after the
    replay, and the pools (the null page aside), ``torch.equal``.
    Eight rows that prefilled 33-64 tokens decode, verify 5 tokens
    and, in the fused step, beside 8 rows ingesting a first chunk."""
    import torch
    from repro_torch.serve import compiled
    cfg, dev = model.cfg, model.device
    B, C, ps, S, T = 8, BITWISE_CHUNK, 16, 64, 5
    rng = np.random.default_rng(seed)
    i32 = dict(dtype=torch.int32, device=dev)

    def ints(hi, shape, lo=0):
        return torch.tensor(rng.integers(lo, hi, shape), **i32)
    per_row = -(-(S + T) // ps)
    tables = torch.arange(2 * B * per_row, **i32).reshape(2 * B, per_row) + 1
    shape = (cfg.n_layers, 1 + 2 * B * per_row, ps, cfg.n_kv_heads,
             cfg.head_dim)
    pools0 = {n: torch.zeros(shape, dtype=torch.bfloat16, device=dev)
              for n in compiled.POOL_KEYS}
    lens = ints(S + 1, (B,), lo=33)
    zeros = torch.zeros(B, **i32)
    with torch.no_grad():
        model.prefill_chunk_paged(params, pools0, ints(cfg.vocab_size,
                                                       (B, S)),
                                  tables[:B], zeros, lens)
    p_rows = tables[B:, :-(-C // ps)].contiguous()

    def inputs(name):
        rows = {"page_tables": tables[:B].clone(),
                "lengths": lens - ints(2, (B,))}
        p = (ints(cfg.vocab_size, (B, C)), p_rows.clone(), zeros.clone(),
             ints(C + 1, (B,), lo=1))
        return {"chunk": ({}, p),
                "decode": (rows, (ints(cfg.vocab_size, (B, 1)),)),
                "verify": (rows, (ints(cfg.vocab_size, (B, T)),)),
                "fused": (rows, (ints(cfg.vocab_size, (B, T)), *p))}[name]

    def flat(x):
        return list(x) if isinstance(x, tuple) else [x]
    methods = {"chunk": model.prefill_chunk_paged,
               "decode": model.decode_step_paged,
               "verify": model.verify_step_paged,
               "fused": model.fused_step_paged}
    stats = compiled.GraphStats()
    out = {}
    with torch.no_grad():
        for name, fn in methods.items():
            prog = compiled.CompiledProgram(name, fn,
                                            compiled.CudaGraphs(dev), stats)
            pools = {n: t.clone() for n, t in pools0.items()}
            extra, args = inputs(name)
            prog(params, {**pools, **extra}, *args)   # eager, captured
            for n, t in pools.items():
                t.copy_(pools0[n])
            extra, args = inputs(name)
            got, _ = prog(params, {**pools, **extra}, *args)   # replay
            want, st = fn(params, {**{n: t.clone() for n, t in
                                      pools0.items()}, **extra}, *args)
            same = [torch.equal(a, b) for a, b in zip(flat(got), flat(want))]
            out[name] = {
                "logits_equal": all(same),
                "max_diff": max(float((a - b).abs().max())
                                for a, b in zip(flat(got), flat(want))),
                "pools_equal": all(torch.equal(pools[n][:, 1:], st[n][:, 1:])
                                   for n in compiled.POOL_KEYS)}
            del prog
    out["replays"] = dict(stats.replays)
    return out


def _graph_gate(where, model, params, programs, opts, trace, *,
                seed) -> dict:
    """Graph == eager: ``trace()`` on the step clock through an engine
    on ``ServePrograms(model, graphs=False)`` and one on the graphed
    ``programs``: the streams, the dispatch counters, both pools (the
    null page aside) and the kernels' launches (each replay credited
    with its capture's) equal, and one dispatch of each program's
    logits (``_graph_logits``).  ``params`` as the engine holds them
    (``prepare_params``).  Fails the run where any differs."""
    import torch
    from repro_torch.launch.serve import serve_trace
    from repro_torch.serve import ServePrograms
    from repro_torch.serve.compiled import POOL_KEYS
    runs = {}
    for kind, progs in (("eager", ServePrograms(model, graphs=False)),
                        ("graphs", programs)):
        engine = opts.build(model, params, programs=progs)
        _launches_reset()
        st = serve_trace(engine, trace(), realtime=False)
        runs[kind] = (
            {r.rid: list(r.generated) for r in engine.finished},
            {k: v for k, v in st.items() if k.startswith("n_")},
            _launches_read(),
            [getattr(engine.cache, n) for n in POOL_KEYS], engine)
    (e_streams, e_counters, e_launches, e_pools, _), \
        (g_streams, g_counters, g_launches, g_pools, g_engine) = \
        runs["eager"], runs["graphs"]
    rec = {"streams_equal": e_streams == g_streams,
           "counters_equal": e_counters == g_counters,
           "pools_equal": all(torch.equal(a[:, 1:], b[:, 1:])
                              for a, b in zip(e_pools, g_pools)),
           "launches_equal": e_launches == g_launches,
           "launches": g_launches,
           "dispatches": int(g_counters["n_total_dispatches"]),
           "graphs_held": g_engine.compiled.graphs(),
           "logits": _graph_logits(model, params, seed=seed)}
    del runs, g_engine, e_pools, g_pools
    held = (rec["streams_equal"] and rec["counters_equal"]
            and rec["pools_equal"] and rec["launches_equal"]
            and all(v["logits_equal"] and v["pools_equal"]
                    for k, v in rec["logits"].items() if k != "replays"))
    if not held:
        fail(f"{where}: the graphed programs differ from eager: {rec}")
    return rec


def _lockstep_logits(model, params, batch, tokens) -> dict:
    """One lockstep decode step through a CUDA graph (``compiled.
    CompiledProgram`` over ``step.make_lockstep_step(model.
    decode_step)``: the cache read and written by address, ``pos`` a device
    scalar), captured at the first step after the prompt (tokens[:, 0])
    and replayed at the next (tokens[:, 1]), against eager
    ``decode_step``s from a copy of the prompt's cache: the replay's
    logits, read from the graph's static output, and every cache
    tensor ``torch.equal``."""
    import torch
    from repro_torch.serve import compiled
    from repro_torch.serve.step import make_lockstep_step
    S = batch["tokens"].shape[1]
    t1, t2 = (tokens[:, i:i + 1].contiguous() for i in (0, 1))
    stats = compiled.GraphStats()
    with torch.no_grad():
        _, cache = model.prefill(params, batch, max_len=S + 2)
        mirror = compiled.nest_map(lambda t: t.clone(), cache)
        prog = compiled.CompiledProgram(
            "lockstep", make_lockstep_step(model.decode_step),
            compiled.CudaGraphs(model.device), stats, state_inputs=("pos",))
        for t in (t1, t2):                  # eager and captured, replayed
            (got, pos), _ = prog(params, cache, t)
            cache["pos"] = pos
        for t in (t1, t2):
            want, mirror = model.decode_step(params, mirror, t)
        rec = {"logits_equal": torch.equal(got, want),
               "max_diff": float((got - want).abs().max()),
               "cache_equal": all(torch.equal(a, b) for a, b in zip(
                   compiled.tensors_of(cache), compiled.tensors_of(mirror))),
               "rows": int(t1.shape[0]), "replays": dict(stats.replays)}
    del prog, cache, mirror
    return rec


def _lockstep_held(rec: dict) -> bool:
    return (rec["tokens_equal"] and rec["logits"]["logits_equal"]
            and rec["logits"]["cache_equal"]
            and rec["logits"]["replays"] == {"lockstep": 1})


def _rescore(model, params, reqs) -> dict:
    """Re-score every served token of ``reqs`` (all of one prompt length
    and one generation length) with one whole-sequence prefill of
    prompt + generated[:-1]: each token must be within TAU of the best
    f32 logit at its position; and every served token against the
    port's ``greedy_generate`` on the same prompts (engine == oracle:
    ``oracle_token_match`` 1.0, which ``_oracle_gate`` requires, as the
    reference's engine tests do).  The whole prefill is held to TAU,
    not to equality: its attention runs the flash kernel where the
    engine's decode runs the paged one, and random-init logits sit on
    knife-edges."""
    import torch
    from repro_torch.serve import greedy_generate
    plen = {len(r.prompt) for r in reqs}
    gen = {len(r.generated) for r in reqs}
    if len(plen) != 1 or len(gen) != 1:
        fail(f"rescore: requests of prompt lengths {sorted(plen)} and "
             f"generated lengths {sorted(gen)}; one of each is needed")
    plen, gen = plen.pop(), gen.pop()
    ctx = torch.tensor(np.stack([np.concatenate(
        [r.prompt, np.asarray(r.generated[:-1], np.int32)]) for r in reqs]),
        device=model.device)
    toks = torch.tensor([r.generated for r in reqs], device=model.device)
    with torch.no_grad():
        logits = model.apply(params, ctx)[:, plen - 1:]
    chosen = logits.gather(-1, toks.long()[..., None])[..., 0]
    gap = logits.max(-1).values - chosen             # (B, gen) >= 0
    oracle = greedy_generate(model, params, ctx[:, :plen], gen,
                             cache_len=plen + gen)
    same = (oracle == toks)
    prefix = same.long().cumprod(1).sum(1)           # tokens before a split
    return {"tau": TAU, "max_gap": float(gap.max()),
            "mean_gap": float(gap.mean()),
            "logit_std": float(logits.std()),
            "teacher_forced_argmax_match": float(
                (logits.argmax(-1) == toks).float().mean()),
            "oracle_token_match": float(same.float().mean()),
            "oracle_exact_requests": int((prefix == gen).sum()),
            "oracle_prefix_mean": float(prefix.float().mean()),
            "finite": torch_isfinite(logits)}


def phase_parity(model, params, done):
    """Every token the serve phase served, re-scored (``_rescore``);
    the greedy oracle, which replays its decode step as a CUDA graph,
    against the same oracle run eagerly (``_oracle_graph_gate``)."""
    rec = _rescore(model, params, done)
    lock = _oracle_graph_gate(model, params, done)
    emit({"phase": "parity", **rec, "lockstep_graph_equals_eager": lock})
    if not rec["finite"]:
        fail("parity: non-finite logits")
    if rec["max_gap"] > TAU:
        fail(f"parity: a served token is {rec['max_gap']} below the "
             f"best logit (tau {TAU})")
    _oracle_gate("parity", rec)
    if not _lockstep_held(lock):
        fail(f"parity: the graphed lockstep decode differs from eager: "
             f"{lock}")


def _oracle_graph_gate(model, params, done) -> dict:
    """``greedy_generate`` on the served prompts replaying its decode
    step as a CUDA graph (one capture, then gen - 2 replays) against
    ``ServePrograms(model, graphs=False)``'s eager loop: the tokens
    equal; and one step's logits after a replay (``_lockstep_logits``,
    on two of the prompts)."""
    import torch
    from repro_torch.serve import ServePrograms, greedy_generate
    prompts = torch.tensor(np.stack([r.prompt for r in done]),
                           device=model.device)
    gen = len(done[0].generated)
    out, toks = {}, {}
    for kind, progs in (("graphs", ServePrograms(model)),
                        ("eager", ServePrograms(model, graphs=False))):
        t0 = time.perf_counter()
        toks[kind] = greedy_generate(model, params, prompts, gen,
                                     cache_len=prompts.shape[1] + gen,
                                     programs=progs)
        torch.cuda.synchronize()
        out[f"{kind}_s"] = time.perf_counter() - t0
        out[f"{kind}_graph_stats"] = progs.graph_stats.as_dict()
    out["tokens_equal"] = torch.equal(toks["graphs"], toks["eager"])
    out["logits"] = _lockstep_logits(model, params,
                                     {"tokens": prompts[:EXTEND_ROWS]},
                                     toks["eager"][:EXTEND_ROWS])
    return out


def _oracle_gate(where: str, rec: dict) -> None:
    """Engine == greedy oracle: every served token equals the port's
    lockstep ``greedy_generate`` on the same prompt."""
    if rec["oracle_token_match"] != 1.0:
        fail(f"{where}: engine != greedy oracle: "
             f"{rec['oracle_exact_requests']} requests exact, token "
             f"match {rec['oracle_token_match']}")


def _kernel_group(name: str) -> str:
    if "paged_attention_kernel" in name:
        return "paged_attention"
    if "flash_attention_kernel" in name:
        return "flash_attention"
    if "flash_bwd_" in name:
        return "flash_attention_bwd"
    if any(t in name for t in ("gemm_bf16", "f32os::")):
        return "gemm_dataflow"
    low = name.lower()
    if any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma", "gemv")):
        return "matmul"
    return "other"


def _profiled_run(backend, reqs) -> dict:
    """Serve ``reqs`` on ``backend`` under torch.profiler
    (``_device_profile``)."""
    before = backend.stats()["n_total_dispatches"]
    prof = _device_profile(lambda: backend.run(reqs))
    st = backend.stats()
    return {"requests": len(reqs),
            "dispatches": int(st["n_total_dispatches"] - before), **prof}


def _device_profile(fn) -> dict:
    """Run ``fn()`` under torch.profiler: device time summed by kernel
    and by group (``_kernel_group``: our kernels by name, library GEMMs
    as "matmul", the rest "other"), against the run's host wall time
    (``seconds``: the whole call, the profiler's own work included).
    The device events are summed straight from the trace: the
    profiler's per-operator tables (``key_averages``) give the same sums
    but take tens of seconds for the ~145,000 kernels a fleet of two
    launches for four requests."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t_call = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        k = by_name.setdefault(e.name(), [0.0, 0])
        k[0] += e.duration_ns() / 1e6
        k[1] += 1
    kernels = [(name, ms, n) for name, (ms, n) in by_name.items()]
    busy_ms = sum(k[1] for k in kernels)
    groups = {}
    for name, ms, n in kernels:
        g = groups.setdefault(_kernel_group(name), {"ms": 0.0, "launches": 0})
        g["ms"] += ms
        g["launches"] += n
    kernels.sort(key=lambda k: -k[1])
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / (wall * 1e3)) if busy_ms
            else None,
            "kernel_launches": sum(k[2] for k in kernels),
            "by_group": groups,
            "top": [[name[:90], ms, n] for name, ms, n in kernels[:12]],
            "seconds": time.perf_counter() - t_call}


def phase_profile(model, params, programs):
    """Where the serve time goes: 8 requests of the same shape through
    a fresh engine under torch.profiler, on the graphed programs (the
    engine's captures included) and eagerly; then 8 other requests of
    the same shapes on the graphed engine again (``warm``: it replays
    every program; an eager engine's second run is its first).
    Returns each run's device idle share and wall ms."""
    from repro_torch.launch.serve import synth_requests
    from repro_torch.serve import ServeOptions, ServePrograms
    out = {}
    for kind, progs, runs in (
            ("graphs", programs, ((2, False), (3, True))),
            ("eager", ServePrograms(model, graphs=False), ((2, False),))):
        engine = None
        for seed, warm in runs:
            reqs = synth_requests(model.cfg, 8, PROMPT_LEN, GEN, rate=50.0,
                                  seed=seed)
            engine = engine or ServeOptions(batch=8).sized_for(reqs).build(
                model, params, programs=progs)
            rec = _profiled_run(engine, reqs)
            emit({"phase": "profile", "programs": kind, "warm": warm, **rec})
            out[f"{kind}_warm" if warm else kind] = {
                "device_idle_share": rec["device_idle_share"],
                "wall_ms": rec["wall_ms"],
                "device_busy_ms": rec["device_busy_ms"]}
    return out


# ------------------------------------------------------------ fleet
def _grouped_requests(cfg, *, seed, integer_arrivals=False):
    """FLEET_REQUESTS requests in FLEET_GROUPS shared-prefix groups
    (prefix FLEET_PREFIX + tail FLEET_TAIL tokens, gen GEN), request i
    in group i % FLEET_GROUPS: Poisson arrivals at 50 req/s, or integer
    arrivals 0..7 (three a step) for the synthetic step clock."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, cfg.vocab_size, FLEET_PREFIX, dtype=np.int32)
                for _ in range(FLEET_GROUPS)]
    arrivals = np.cumsum(rng.exponential(1.0 / 50.0, size=FLEET_REQUESTS))
    reqs = []
    for i in range(FLEET_REQUESTS):
        tail = rng.integers(0, cfg.vocab_size, FLEET_TAIL, dtype=np.int32)
        reqs.append(Request(
            rid=i, prompt=np.concatenate([prefixes[i % FLEET_GROUPS], tail]),
            max_new_tokens=GEN,
            arrival=(float(i * 8 // FLEET_REQUESTS) if integer_arrivals
                     else float(arrivals[i]))))
    return reqs


def _fleet_drive(backend, reqs, *, synthetic=False, events=None):
    """Submit ``reqs`` and step ``backend`` until it is idle, draining
    its stream events after every step: on the wall clock (seconds since
    the first step, so arrivals replay in real time) or on a synthetic
    step clock (step t runs at now = t, after ``events[t]``).  Returns
    (tokens streamed per rid, finish events per rid, wall seconds)."""
    import torch
    for r in reqs:
        backend.submit(r)
    streamed, finishes = {}, {}
    t, t0 = 0, time.perf_counter()
    while True:
        for fn in (events or {}).get(t, ()):
            fn(backend)
        now = float(t) if synthetic else time.perf_counter() - t0
        more = backend.step(now=now)
        for ev in backend.drain_events():
            streamed.setdefault(ev.rid, []).extend(ev.tokens)
            finishes[ev.rid] = finishes.get(ev.rid, 0) + int(ev.finished)
        t += 1
        if not more:
            break
    torch.cuda.synchronize()
    return streamed, finishes, time.perf_counter() - t0


def _fleet_record(sub, model, params, backend, done, n_requests, wall,
                  peak_gb, launches, t_start, *, streamed=None,
                  finishes=None, gates=None, **extra):
    """Emit one sub-run's line and hold it to the fleet gates: every
    request finished with its budget, every token within TAU of the
    re-score, each request's events concatenate to its stream (one
    finish event each), allocator invariants on every live replica, the
    fleet dispatch identity, and both attention kernels launched at
    least once a layer for every dispatch that needs them (from the
    fleet's folded counters); then the sub-run's own ``gates``."""
    from repro_torch.launch.serve import fleet_of
    st = backend.stats()
    want = _launch_gates(model, st)
    engines = fleet_of(backend)[1]
    done = sorted(done, key=lambda r: r.rid)
    toks = sum(len(r.generated) for r in done)
    ttfts = [r.ttft for r in done if r.ttft is not None]
    rescore = _rescore(model, params, done)
    checks = {
        "all_finished": len(done) == n_requests and all(
            len(r.generated) == r.max_new_tokens for r in done),
        "rescore_within_tau": rescore["finite"]
        and rescore["max_gap"] <= TAU,
        "dispatch_identity": st["n_total_dispatches"] == (
            st["n_prefill_dispatches"] + st["n_decode_steps"]
            + st["n_replay_steps"] - st["n_fused_dispatches"]),
        **{f"{k}_launched": launches[k] >= want[k] and launches[k] > 0
           for k in want}}
    if streamed is not None:
        checks["events_equal_streams"] = all(
            streamed.get(r.rid, []) == list(r.generated)
            and finishes.get(r.rid) == 1 for r in done)
    try:
        for e in engines:
            e.cache.check_invariants()
        checks["invariants"] = True
    except AssertionError:
        checks["invariants"] = False
    checks.update(gates(st) if gates else {})
    emit({"phase": "fleet", "sub_run": sub, "requests": len(done),
          "tokens": toks, "wall_s": wall, "tok_per_s": toks / wall,
          "ttft_mean_s": float(np.mean(ttfts)) if ttfts else None,
          "peak_mem_gb": peak_gb,
          "kv_pool_gb_per_replica": [2 * e.cache.k_pages.numel() * 2 / 1e9
                                     for e in engines],
          "counters": {k: (int(v) if float(v).is_integer() else v)
                       for k, v in st.items()},
          "launches": launches, "launches_expected": want,
          "rescore": rescore, **extra, "gates": checks,
          "seconds": time.perf_counter() - t_start,
          "card": nvidia_smi_line()})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"fleet [{sub}]: gates failed: {bad}")


def _peak_gb(device=None) -> float:
    """The peak allocated GB of ``device`` (default the current one)."""
    import torch
    return torch.cuda.max_memory_allocated(device) / 1e9


def _fleet_router(model, params, programs):
    """(a) 2 replicas behind the prefix-affinity router, realtime; the
    same trace through one engine (reported); and 4 of its requests (one
    a group) through a fresh 2-replica fleet and through a fresh engine,
    each under torch.profiler (as the profile phase)."""
    t0 = time.perf_counter()
    import torch
    from repro_torch.serve import ServeOptions
    reqs = _grouped_requests(model.cfg, seed=3)
    opts = ServeOptions(batch=8, replicas=2,
                        router_policy="prefix").sized_for(
        reqs, shared_prefix=FLEET_PREFIX)
    torch.cuda.reset_peak_memory_stats()
    router = opts.build(model, params, programs=programs)
    _launches_reset()
    streamed, finishes, wall = _fleet_drive(router, reqs)
    launches, peak = _launches_read(), _peak_gb()
    one = _grouped_requests(model.cfg, seed=3)
    one_opts = ServeOptions(batch=8).sized_for(one,
                                               shared_prefix=FLEET_PREFIX)
    _, _, one_wall = _fleet_drive(
        one_opts.build(model, params, programs=programs), one)
    mine = {r.rid: r.generated for r in router.finished}
    equal = sum(a == b for r in one for a, b in zip(r.generated,
                                                    mine[r.rid]))
    one_ttft = [r.ttft for r in one if r.ttft is not None]
    prof = {}
    for name, o in (("fleet", opts), ("one_engine", one_opts)):
        rec = _profiled_run(o.build(model, params, programs=programs),
                            _grouped_requests(model.cfg, seed=3)[:4])
        prof[name] = {k: v for k, v in rec.items() if k != "top"}
    _fleet_record(
        "router", model, params, router, router.finished, len(reqs), wall,
        peak, launches, t0, streamed=streamed, finishes=finishes,
        gates=lambda st: {"affinity_hits": st["n_affinity_hits"] > 0},
        replicas=2, policy="prefix", batch=opts.batch,
        n_pages=opts.n_pages, n_dispatched=list(router.n_dispatched),
        one_engine={"tok_per_s": sum(len(r.generated) for r in one)
                    / one_wall, "wall_s": one_wall,
                    "ttft_mean_s": float(np.mean(one_ttft))},
        tokens_equal_to_one_engine=equal / (len(one) * GEN),
        profile=prof)
    return launches


def _fleet_churn(model, params, programs):
    """(b) 2 replicas, replica 1 crashing at its own step CHURN_CRASH_AT,
    a third joining at step CHURN_JOIN_AT and replica 0 drained at step
    CHURN_DRAIN_AT, on the synthetic step clock."""
    t0 = time.perf_counter()
    import torch
    from repro_torch.serve import (FaultInjector, RequestRouter,
                                   ServeOptions, Telemetry)
    reqs = _grouped_requests(model.cfg, seed=4, integer_arrivals=True)
    opts = ServeOptions(batch=8, telemetry=Telemetry()).sized_for(
        reqs, shared_prefix=FLEET_PREFIX)
    torch.cuda.reset_peak_memory_stats()

    def mk():
        return opts.build(model, params, programs=programs)

    router = RequestRouter([mk(), FaultInjector(mk(),
                                                crash_at=CHURN_CRASH_AT)],
                           policy="prefix", telemetry=opts.telemetry)
    seen = {}

    def join(r):
        seen["join"] = {"t": CHURN_JOIN_AT, "fleet_inflight": r.n_inflight,
                        "replica_id": r.add_replica(mk())}

    def drain(r):
        seen["drain"] = {"t": CHURN_DRAIN_AT,
                         "replica_0_inflight": r.replicas[0].n_inflight}
        r.drain(0)

    _launches_reset()
    streamed, finishes, wall = _fleet_drive(
        router, reqs, synthetic=True,
        events={CHURN_JOIN_AT: [join], CHURN_DRAIN_AT: [drain]})
    launches, peak = _launches_read(), _peak_gb()
    _fleet_record(
        "churn_crash", model, params, router, router.finished, len(reqs),
        wall, peak, launches, t0, streamed=streamed, finishes=finishes,
        gates=lambda st: {
            "joined": st["n_joined"] >= 1,
            "migrated": st["n_migrations"] >= 1,
            "one_failure": st["n_failures"] == 1,
            "recovered": st["n_recovered_requests"] >= 1,
            "replay_covers_recovery": st["n_replay_steps"]
            >= st["n_recovery_replayed_tokens"]},
        crash_at_replica_step=CHURN_CRASH_AT, events=seen,
        n_dispatched_live=list(router.n_dispatched),
        note="TTFT in synthetic steps")
    return launches


def _fleet_stream(model, params, programs):
    """(c) the streaming front-end over an elastic fleet of 1..2
    replicas, two weighted tenants, every 4th request interactive."""
    t0 = time.perf_counter()
    import torch
    from repro_torch.launch.serve import run_stream, synth_requests
    from repro_torch.serve import ServeOptions
    reqs = synth_requests(model.cfg, STREAM_REQUESTS, PROMPT_LEN, GEN,
                          rate=50.0, seed=5)
    opts = ServeOptions(batch=8, max_replicas=2, stream=True,
                        tenant_weights={"gold": 3, "free": 1}).sized_for(reqs)
    torch.cuda.reset_peak_memory_stats()
    _launches_reset()
    out = run_stream(opts, model, params, reqs, programs=programs)
    launches, peak = _launches_read(), _peak_gb()
    fe = out["frontend"]
    streams_ok = all(list(s) == list(s.req.generated)
                     for s in out["streams"].values())
    _fleet_record(
        "stream", model, params, fe.backend, fe.completed, len(reqs),
        out["wall_s"], peak, launches, t0,
        gates=lambda st: {"token_streams_equal_generated": streams_ok
                          and len(out["streams"]) == len(reqs)},
        ttft_by_class=out["ttft_by_class"],
        tenant_tokens=out["tenant_tokens"],
        n_slo_preemptions=out["n_slo_preemptions"])
    return launches


def _recording_proposals(drafter) -> list:
    """Log each of ``drafter``'s proposals: (slot, rid, context length,
    k, the drafts)."""
    log, propose = [], drafter.propose

    def logged(slot, req, k):
        out = propose(slot, req, k)
        log.append((slot, req.rid, len(req.prompt) + len(req.generated),
                    k, list(out)))
        return out
    drafter.propose = logged
    return log


def _draft_reused_slot(drafter, cfg) -> dict:
    """A slot of ``drafter`` (its graphs captured on the trace's caches)
    serves a request that needs less room than the slot's cache holds,
    so the paged kernel decodes over a longer page than a fresh cache
    would give it, against a fresh eager ``DraftModelDrafter`` on the
    same request: two rounds of 4 drafts, the second after a rejected
    draft (a rewind), are equal, and the graphed drafter replayed."""
    from repro_torch.launch.serve import synth_requests
    from repro_torch.serve import DraftModelDrafter, ServePrograms
    req = synth_requests(cfg, 1, DRAFT_PROMPT_LEN // 2, DRAFT_GEN // 2,
                         rate=50.0, seed=7)[0]
    slot = min(drafter._caches)
    fresh = DraftModelDrafter(drafter.model, drafter.params, cfg_target=cfg,
                              programs=ServePrograms(drafter.model,
                                                     graphs=False))
    stats = drafter._decode.program.stats
    replays = stats.replays["lockstep"]
    rounds = []
    for _ in range(2):
        got = DraftModelDrafter.propose(drafter, slot, req, 4)
        want = fresh.propose(slot, req, 4)
        rounds.append([got, want])
        # the first draft accepted, the second replaced
        req.generated += [want[0], (want[1] + 1) % cfg.vocab_size]
    rec = {"drafts_equal": all(a == b and len(a) == 4 for a, b in rounds),
           "rounds": rounds, "room": drafter._caches[slot]["room"],
           "cap": drafter._slots[slot]["cap"],
           "replayed": stats.replays["lockstep"] > replays}
    rec["drafts_equal"] &= rec["room"] > rec["cap"]
    drafter.detach(slot)
    return rec


def _fleet_draft(model, params, programs):
    """(d) one engine drafting with a second full-width qwen3-0.6b
    (seed 1) through ``--draft-config``, on shorter requests: the draft
    model consumes each context one token at a time, replaying its
    decode step as a CUDA graph a slot (``DraftModelDrafter``).  Then
    the same trace through an engine whose drafter decodes eagerly
    (``ServePrograms(draft, graphs=False)``): every proposal, the
    drafted count, the accept rate and the streams equal; a reused slot
    with more room than its request needs drafts as a fresh eager
    drafter does (``_draft_reused_slot``); and one draft decode's logits
    after a replay (``_lockstep_logits``)."""
    t0 = time.perf_counter()
    import dataclasses
    import torch
    from repro_torch.launch.serve import synth_requests
    from repro_torch.serve import (DraftModelDrafter, ServeOptions,
                                   ServePrograms)

    def trace():
        return synth_requests(model.cfg, DRAFT_REQUESTS, DRAFT_PROMPT_LEN,
                              DRAFT_GEN, rate=50.0, seed=6)
    reqs = trace()
    opts = ServeOptions(batch=8, spec_k=4,
                        draft_config="qwen3-0.6b").sized_for(reqs)
    torch.cuda.reset_peak_memory_stats()
    engine = opts.build(model, params, programs=programs)
    drafter = engine.drafter
    proposals = _recording_proposals(drafter)
    _launches_reset()
    streamed, finishes, wall = _fleet_drive(engine, reqs)
    launches, peak = _launches_read(), _peak_gb()
    st = engine.stats()
    # the same trace with the drafter decoding eagerly
    eager = dataclasses.replace(opts, draft_config="").build(
        model, params, programs=programs)
    eager.drafter = DraftModelDrafter(
        drafter.model, drafter.params, cfg_target=model.cfg,
        programs=ServePrograms(drafter.model, graphs=False))
    e_proposals = _recording_proposals(eager.drafter)
    e_streamed, _, e_wall = _fleet_drive(eager, trace())
    e_st = eager.stats()
    dprogs = drafter._decode.program
    prompt = torch.tensor(reqs[0].prompt, device=model.device)[None]
    reused = _draft_reused_slot(drafter, model.cfg)
    check = {
        "proposals_equal": proposals == e_proposals,
        "proposals": len(proposals),
        "n_drafted": [int(st["n_drafted"]), int(e_st["n_drafted"])],
        "accept_rate": [float(st["accept_rate"]),
                        float(e_st["accept_rate"])],
        "streams_equal": streamed == e_streamed,
        "wall_s": {"graphs": wall, "eager": e_wall},
        "draft_graphs_held": len(dprogs),
        "draft_graph_stats": {"captures": dprogs.stats.captures["lockstep"],
                              "replays": dprogs.stats.replays["lockstep"]},
        "reused_slot": reused,
        "logits": _lockstep_logits(
            drafter.model, drafter.params, {"tokens": prompt},
            torch.tensor([[int(reqs[0].generated[0]),
                           int(reqs[0].generated[1])]],
                         device=model.device))}
    held = (check["proposals_equal"] and check["streams_equal"]
            and check["n_drafted"][0] == check["n_drafted"][1]
            and check["accept_rate"][0] == check["accept_rate"][1]
            and check["logits"]["logits_equal"]
            and check["logits"]["cache_equal"]
            and reused["drafts_equal"] and reused["replayed"])
    del eager
    _fleet_record(
        "draft", model, params, engine, engine.finished, len(reqs), wall,
        peak, launches, t0, streamed=streamed, finishes=finishes,
        gates=lambda st: {"drafted": st["n_drafted"] > 0,
                          "no_drafter_state_left":
                          engine.drafter._slots == {},
                          "draft_graph_equals_eager": held},
        draft=type(engine.drafter).__name__, draft_seed=1,
        prompt_len=DRAFT_PROMPT_LEN, gen=DRAFT_GEN,
        accept_rate=float(st["accept_rate"]),
        draft_graph_equals_eager=check)
    return launches


def phase_fleet(model, params, programs):
    """The serving fleet on one card, on the serve phase's model, params
    and program bundle: (a) router, (b) churn and crash, (c) stream,
    (d) draft model.  Returns the attention kernels' launches summed
    over the sub-runs' measured drives."""
    total = dict.fromkeys(PATH_COUNTERS, 0)
    t0 = time.perf_counter()
    for sub in (_fleet_router, _fleet_churn, _fleet_stream, _fleet_draft):
        for k, n in sub(model, params, programs).items():
            total[k] += n
    emit({"phase": "fleet", "seconds": time.perf_counter() - t0,
          "launches": total})
    return total


# ------------------------------------------------------------ archs
def _arch_config(name):
    """(FULL config as run on the card, its cuts as {key: [published,
    run]})."""
    import dataclasses
    from repro_torch import configs
    cfg = configs.get(name)
    if cfg.moe is None:
        return cfg, {}
    run = dataclasses.replace(
        cfg, n_layers=SCOUT_LAYERS,
        moe=dataclasses.replace(cfg.moe, capacity_factor=SCOUT_CAPACITY))
    return run, {"n_layers": [cfg.n_layers, SCOUT_LAYERS],
                 "capacity_factor": [cfg.moe.capacity_factor,
                                     SCOUT_CAPACITY]}


def _capture_first_route():
    """Wrap ``components.moe_route`` so that its first call's input,
    router and expert ids are kept.  Returns (record, undo)."""
    from repro_torch.models import components as C
    orig, seen = C.moe_route, {}

    def route(p, xf, cfg):
        out = orig(p, xf, cfg)
        if not seen:
            seen.update(x=xf.clone(), router=p["router"], ids=out[2].clone())
        return out
    C.moe_route = route
    return seen, lambda: setattr(C, "moe_route", orig)


def _route_check(seen, cfg) -> dict:
    """Layer 0's routed experts on the serve trace's first chunk against
    the top-k of an f32 recomputation of its router logits (softmax is
    monotone: the logits' order is the probabilities')."""
    import torch
    logits = seen["x"].float() @ seen["router"].float()
    want = torch.topk(logits, cfg.moe.top_k, dim=-1).indices
    return {"tokens": int(seen["ids"].shape[0]),
            "routed_ids_equal_f32_router": bool(torch.equal(seen["ids"],
                                                            want)),
            "tokens_per_expert": torch.bincount(
                seen["ids"][:, 0], minlength=cfg.moe.n_experts).tolist()}


#: row counts of the probed products: decode (8), the oracle's decode
#: (16), verify (40), a chunk (256) and a whole prefill (2,048), against
#: the re-score's 4,096 (16 prompts of 256)
ROW_COUNTS = (1, 8, 16, 40, 256, 2048)
PROBE_ROWS = 4096


def _probe_layers(params):
    """(name, parameters) of the first layer of each kind in a
    parameter tree: ``layers[0]`` of a stacked stack, a leading
    ``dense_layer_0``, the first unscanned ``layer_NN`` of each block
    kind, whisper's ``enc_00`` and ``dec_00``."""
    out, kinds = [], set()
    for name in sorted(params):
        node = params[name]
        if name == "layers":
            out.append(("layers/0", {k: _layer0(v) for k, v in node.items()}))
        elif name.startswith(("dense_layer_", "enc_", "dec_", "layer_")) \
                and "ln1" in node:
            kind = (name.split("_")[0], tuple(sorted(node.get("mix", node))))
            if kind not in kinds:
                kinds.add(kind)
                out.append((name, node))
    return out


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


def _row_bits(model, params) -> dict:
    """Whether a row's bits depend on the rows it shares a call with,
    for every product of the first layer of each kind (``_probe_layers``)
    at this model's widths, called as the model calls it: each
    projection through ``components.linear`` in the dtype its weight is
    stored in (bf16 projections, f32 routers and gates), RWKV6's token
    mix per slice, an MoE's experts' batched products (``bmm`` of (E, M,
    K) by (E, K, N)) and the whole ``moe_block``; and the f32
    unembedding (``components.unembed``).  The M rows from row 37 of a
    PROBE_ROWS-row input, called alone, are held against the same rows
    of the whole call (``torch.equal``).  Returns the row counts M at
    which a product gave other bits, by product (all empty:
    row-stable)."""
    import torch
    from repro_torch.models import components as C
    cfg = model.cfg
    g = torch.Generator(device=params["embed"]["tok"].device)
    g.manual_seed(13)

    def rows(k, dtype):
        return torch.randn(PROBE_ROWS, k, generator=g,
                           device=g.device).to(dtype)

    def unstable(fn, a):
        full = fn(a)
        return [m for m in ROW_COUNTS
                if not torch.equal(fn(a[..., 37:37 + m, :].contiguous()),
                                   full[..., 37:37 + m, :])]

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), v
    skip = {"conv_w", "u", "ln_x_scale", "ln_x_bias"}
    out = {}
    for layer, tree in _probe_layers(params):
        for path, w in leaves(tree):
            name = "/".join((layer,) + path)
            if path[-1] in skip or w.dim() < 2 or w.shape[0] == 1:
                continue
            if path[-1] == "tm_w2":
                for i in range(w.shape[0]):
                    out[f"{name}[{i}]"] = unstable(
                        lambda a: C.linear(a, w[i]), rows(w.shape[1],
                                                           w.dtype))
            elif w.dim() == 2:
                out[name] = unstable(lambda a: C.linear(a, w),
                                     rows(w.shape[0], w.dtype))
            else:                             # (E, K, N) experts
                x = rows(w.shape[1], w.dtype)[None].expand(w.shape[0], -1,
                                                           -1)
                out[name] = unstable(lambda a: torch.bmm(a, w),
                                     x.contiguous())
        ffn = tree.get("ffn", {})
        if "router" in ffn:
            out[f"{layer}/moe_block"] = unstable(
                lambda a: C.moe_block(ffn, a, cfg)[0],
                rows(cfg.d_model, torch.bfloat16)[None])
    out["unembed"] = unstable(
        lambda a: C.unembed(params["embed"], a, cfg),
        rows(cfg.d_model, torch.float32))
    return out


def _row_bits_gate(where: str, row_bits: dict) -> None:
    bad = {k: v for k, v in row_bits.items() if v}
    if bad:
        fail(f"{where}: a product's row bits depend on the rows of its "
             f"call: {bad}")


def _serve_arch(name):
    """One architecture at full width on the card (``_arch_config``):
    seeded random init, a warm-up, the serve phase's trace, the re-score,
    the launch gates and the bitwise invariants.  Returns the attention
    kernels' launches on the trace."""
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.launch.serve import serve_trace, synth_requests
    from repro_torch.models.lm import DecoderLM
    from repro_torch.serve import ServeOptions, ServePrograms
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    cfg, reduced = _arch_config(name)
    model = DecoderLM(cfg)
    programs = ServePrograms(model)
    torch.cuda.reset_peak_memory_stats()
    # the projections in bf16 once, for the engines and the re-score
    # alike (the casts are exact); their f32 originals are freed here
    params = programs.prepare_params(model.init(seed=0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in tree_leaves(params))
    opts = ServeOptions(batch=8)
    warm = synth_requests(cfg, 2, PROMPT_LEN, 4, rate=50.0, seed=1)
    opts.sized_for(warm).build(model, params, programs=programs).run(warm)
    torch.cuda.synchronize()

    reqs = synth_requests(cfg, N_REQUESTS, PROMPT_LEN, GEN, rate=50.0)
    opts = opts.sized_for(reqs)
    engine = opts.build(model, params, programs=programs)
    seen, undo = (_capture_first_route() if cfg.moe is not None
                  else (None, lambda: None))
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    _launches_reset()
    try:
        stats = serve_trace(engine, reqs, realtime=True)
    finally:
        undo()
    launches = _launches_read()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = _launch_gates(model, stats)
    done = sorted(engine.finished, key=lambda r: r.rid)
    rescore = _rescore(model, params, done)
    bitwise = _bitwise_invariants(model, params, seed=9)
    full = configs.get(name)
    rec = {"phase": "archs", "arch": cfg.name, "layers": cfg.n_layers,
           "layers_full": full.n_layers, "reduced": reduced,
           "n_params": n_params, "n_params_full": full.n_params(),
           "H": cfg.n_heads, "KVH": cfg.n_kv_heads, "Dh": cfg.head_dim,
           "init_s": init_s, "requests": stats["requests"],
           "prompt_len": PROMPT_LEN, "gen": GEN, "batch": opts.batch,
           "n_pages": opts.n_pages,
           "kv_pool_gb": 2 * engine.cache.k_pages.numel() * 2 / 1e9,
           "tokens": stats["tokens"], "wall_s": stats["wall_s"],
           "tok_per_s": stats["tok_per_s"],
           "ttft_mean_s": stats["ttft_mean_s"], "peak_mem_gb": peak_gb,
           "init_peak_mem_gb": init_peak_gb,
           "counters": {k: v for k, v in stats.items()
                        if k.startswith("n_") or k == "accept_rate"},
           "launches": launches, "launches_expected": want,
           "rescore": rescore, "bitwise": bitwise}
    if seen is not None:
        rec["route"] = _route_check(seen, cfg)
        # the MoE and its cuBLAS experts through the graphs
        rec["graph_equals_eager"] = _graph_gate(
            f"archs [{cfg.name}]", model, params, programs, opts,
            lambda: synth_requests(cfg, N_REQUESTS, PROMPT_LEN, GEN,
                                   rate=50.0), seed=11)
    rec["row_bits"] = _row_bits(model, params)
    rec.update(seconds=time.perf_counter() - t0, card=nvidia_smi_line())
    emit(rec)
    if len(done) != N_REQUESTS or any(len(r.generated) != GEN
                                      for r in done):
        fail(f"archs [{cfg.name}]: {len(done)} requests finished, "
             f"generated {[len(r.generated) for r in done]} tokens")
    if not rescore["finite"] or rescore["max_gap"] > TAU:
        fail(f"archs [{cfg.name}]: re-score max gap {rescore['max_gap']} "
             f"(tau {TAU}), finite {rescore['finite']}")
    _oracle_gate(f"archs [{cfg.name}]", rescore)
    for k, n in want.items():
        if launches[k] < n or launches[k] == 0:
            fail(f"archs [{cfg.name}]: {k} launched {launches[k]} times, "
                 f"the path's dispatches need {n}")
    if not _bitwise_held(bitwise):
        fail(f"archs [{cfg.name}]: a model-level bitwise invariant failed: "
             f"{bitwise}")
    _row_bits_gate(f"archs [{cfg.name}]", rec["row_bits"])
    return launches


def phase_archs():
    """The other architectures the port serves, one after the other on
    the card (each freed before the next).  Returns the attention
    kernels' launches summed over their serve traces."""
    import gc
    import torch
    total = dict.fromkeys(PATH_COUNTERS, 0)
    t0 = time.perf_counter()
    for name in ARCHS_ON_CARD:
        for k, n in _serve_arch(name).items():
            total[k] += n
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "archs", "seconds": time.perf_counter() - t0,
          "launches": total})
    return total


# ------------------------------------------------------------------ tp
def _tp_dispatches(model, p1, progs, ptp) -> dict:
    """One dispatch of each program at full width on fresh pools (TP_PAGES
    pages of 16): a chunk of TP_CHUNK prompt tokens for 2 rows, a
    decode step, a verify at T 5 and a fused step (the 2 rows decoding,
    a third prefilling).  Each program's logits on every shard are
    ``torch.equal`` to tp 1's, and the pools after them equal tp 1's
    head slices.  These launches are not counted."""
    import torch
    cfg, dev = model.cfg, model.device
    shape = (cfg.n_layers, TP_PAGES, 16, cfg.n_kv_heads, cfg.head_dim)
    s1 = {n: torch.zeros(shape, dtype=torch.bfloat16, device=dev)
          for n in ("k_pages", "v_pages")}
    stp = {n: progs.prepare_pages(t.clone()) for n, t in s1.items()}
    g = torch.Generator(device=dev).manual_seed(11)

    def tok(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=g,
                             device=dev, dtype=torch.int32)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    def flat(x):
        return list(x) if isinstance(x, tuple) else [x]
    out = {}

    def both(name, method, *args, extra=None):
        want = flat(getattr(model, method)(p1, {**s1, **(extra or {})},
                                           *args)[0])
        got = progs.map_shards(
            lambda m, gather, p, st, *a: getattr(m, method)(
                p, st, *a, gather=gather)[0],
            ptp, {**stp, **(extra or {})}, *args)
        # shards on other cards: compared on the model's card
        got = [[a.to(dev) for a in flat(s)] for s in got]
        out[name] = {
            "equal_to_tp1": all(torch.equal(a, b) for a, b in
                                zip(got[0], want)),
            "shards_equal": all(torch.equal(a, b) for s in got[1:]
                                for a, b in zip(s, got[0])),
            "max_abs_diff": max(float((a - b).abs().max()) for a, b in
                                zip(got[0], want))}
    tables = i32([[1, 2, 3, 4], [5, 6, 7, 8]])
    n = TP_CHUNK
    both("chunk", "prefill_chunk_paged", tok(2, n), tables, i32([0, 0]),
         i32([n, n]))
    state = {"page_tables": tables, "lengths": i32([n, n])}
    both("decode", "decode_step_paged", tok(2, 1), extra=state)
    both("verify_T5", "verify_step_paged", tok(2, 5),
         extra={**state, "lengths": i32([n + 1, n + 1])})
    both("fused", "fused_step_paged", tok(2, 1), tok(1, n),
         i32([[9, 10, 11, 12]]), i32([0]), i32([n]),
         extra={**state, "lengths": i32([n + 6, n + 6])})
    out["pages_equal"] = all(
        torch.equal(piece[:, 1:].to(dev), want[:, 1:])
        for name in ("k_pages", "v_pages")
        for piece, want in zip(stp[name].shards,
                               s1[name].chunk(progs.tp, -2)))
    return out


def _tp_run(model, params, programs, reqs, opts, devices):
    """One engine on ``programs`` serves ``reqs`` on the step clock (so a
    tp-way engine and tp 1 take the same steps and the same pages).
    Returns (engine, stats, launches, the peak GB of each distinct card
    of ``devices``)."""
    import gc
    import torch
    from repro_torch.launch.serve import serve_trace
    cards = sorted(set(devices), key=str)
    engine = opts.build(model, params, programs=programs)
    gc.collect()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    _launches_reset()
    stats = serve_trace(engine, reqs, realtime=False)
    return engine, stats, _launches_read(), [_peak_gb(d) for d in cards]


def _tp_graph_logits(model, progs, ptp) -> dict:
    """One dispatch of each program through the pieces' CUDA graphs
    (``parallel.PiecewiseProgram`` over the model's logits-returning
    method, the engine's programs but for the argmax), captured on some
    inputs and replayed on others, against the eager ``TPServePrograms``
    on the replay's inputs from the same pools: shard 0's logits read
    from the graphs' static output, and every shard's pools (the null
    page aside), ``torch.equal``.  Pools of TP_PAGES random pages of
    16; two rows decode, verify 5 tokens and, in the fused step, beside
    a third ingesting a chunk of TP_CHUNK tokens."""
    import torch
    from repro_torch.serve import compiled
    from repro_torch.serve.parallel import PiecewiseProgram, ShardedPages
    cfg, dev = model.cfg, model.device
    shape = (cfg.n_layers, TP_PAGES, 16, cfg.n_kv_heads, cfg.head_dim)
    g = torch.Generator(device=dev).manual_seed(12)
    base = {n: progs.prepare_pages(torch.randn(
        shape, generator=g, device=dev).bfloat16())
        for n in compiled.POOL_KEYS}
    rng = np.random.default_rng(12)
    n = TP_CHUNK

    def pools():
        return {k: ShardedPages([t.clone() for t in v.shards])
                for k, v in base.items()}

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    def tok(*shape):
        return i32(rng.integers(0, cfg.vocab_size, shape))

    def inputs(name):
        rows = {"page_tables": i32([[1, 2, 3, 4], [5, 6, 7, 8]]),
                "lengths": i32(rng.integers(n - 8, n + 1, 2))}
        p = (tok(1, n), i32([[9, 10, 11, 12]]), i32([0]),
             i32([int(rng.integers(n - 8, n + 1))]))
        return {"chunk": ({}, (tok(2, n), rows["page_tables"], i32([0, 0]),
                               i32(rng.integers(n - 8, n + 1, 2)))),
                "decode": (rows, (tok(2, 1),)),
                "verify": (rows, (tok(2, 5),)),
                "fused": (rows, (tok(2, 5), *p))}[name]

    def flat(x):
        return list(x) if isinstance(x, tuple) else [x]
    methods = {"chunk": "prefill_chunk_paged", "decode": "decode_step_paged",
               "verify": "verify_step_paged", "fused": "fused_step_paged"}
    stats = compiled.GraphStats()
    out = {}
    with torch.no_grad():
        for name, method in methods.items():
            prog = PiecewiseProgram(name, progs, {
                d: compiled.CudaGraphs(d)
                for d in dict.fromkeys(progs.devices)}, stats)
            prog.maker = lambda m, gather, method=method: (
                lambda p, st, *a: getattr(m, method)(p, st, *a,
                                                     gather=gather))
            st = pools()
            extra, args = inputs(name)
            prog(ptp, {**st, **extra}, *args)          # eager, captured
            for k in compiled.POOL_KEYS:
                for a, b in zip(st[k].shards, base[k].shards):
                    a.copy_(b)
            extra, args = inputs(name)
            got, _ = prog(ptp, {**st, **extra}, *args)     # replayed
            want_st = pools()
            want = progs.map_shards(
                lambda m, gather, p, s, *a, method=method: getattr(
                    m, method)(p, s, *a, gather=gather)[0],
                ptp, {**want_st, **extra}, *args)[0]
            got = [a.to(dev) for a in flat(got)]
            want = [a.to(dev) for a in flat(want)]
            (graph,) = prog._graphs.values()
            out[name] = {
                "logits_equal": all(torch.equal(a, b)
                                    for a, b in zip(got, want)),
                "max_diff": max(float((a - b).abs().max())
                                for a, b in zip(got, want)),
                "pools_equal": all(
                    torch.equal(a[:, 1:], b[:, 1:])
                    for k in compiled.POOL_KEYS
                    for a, b in zip(st[k].shards, want_st[k].shards)),
                "segments": graph.n_segments}
            del prog, graph, st, want_st
    out["replays"] = dict(stats.replays)
    return out


def _serve_tp(name, tps) -> dict:
    """``name`` at full size (seeded random init, projections bf16) on
    the serve phase's trace at tp 1 and at each tp of ``tps``, the
    shards placed by ``device_plan`` (a card each, ``make_tp_devices``,
    where there are enough cards, else co-located on the card by name);
    gated on streams, pools, launches and one dispatch of each
    program."""
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.launch.mesh import device_plan
    from repro_torch.launch.serve import synth_requests
    from repro_torch.models.lm import DecoderLM
    from repro_torch.serve import ServeOptions, ServePrograms
    from repro_torch.serve.parallel import TPServePrograms
    t0 = time.perf_counter()
    cfg = configs.get(name)
    model = DecoderLM(cfg)
    # tp 1 and the tp-way engines replay CUDA graphs (the tp-way ones in
    # pieces cut at their gathers, serve/parallel.py)
    one = ServePrograms(model)
    params = one.prepare_params(model.init(seed=0))
    opts = ServeOptions(batch=TP_BATCH)

    def trace():
        return synth_requests(cfg, TP_REQUESTS, PROMPT_LEN, GEN, rate=50.0)
    opts = opts.sized_for(trace())
    warm = synth_requests(cfg, 2, PROMPT_LEN, 4, rate=50.0, seed=1)
    opts.sized_for(warm).build(model, params, programs=one).run(warm)
    base, st1, l1, peak1 = _tp_run(model, params, one, trace(), opts,
                                   [model.device])
    streams = {r.rid: r.generated for r in base.finished}
    readings = {1: {"tok_per_s": st1["tok_per_s"], "wall_s": st1["wall_s"],
                    "peak_mem_gb_per_card": peak1, "launches": l1,
                    "kv_pool_gb": 2 * base.cache.k_pages.nbytes / 1e9}}
    ok = len(streams) == TP_REQUESTS and all(
        len(s) == GEN for s in streams.values())
    failures = [] if ok else [f"tp 1: {len(streams)} streams"]
    # more admissions than slots: a slot and its pages served again
    if base._admit_counter <= opts.batch:
        failures.append(f"tp 1: {base._admit_counter} admissions into "
                        f"{opts.batch} slots")
    counters = [k for k in st1 if k.startswith("n_")]
    launches = dict.fromkeys(PATH_COUNTERS, 0)
    plans = {}
    for tp in tps:
        devices, _ = device_plan(tp)
        own = len(set(devices)) == tp
        plans[tp] = {"devices": [str(d) for d in devices],
                     "card_a_shard": own}
        emit({"phase": "tp", "arch": cfg.name, "tp": tp, "plan": plans[tp]})
        # a card a shard: the launcher's default (make_tp_devices)
        progs = (TPServePrograms(model, tp=tp) if own else
                 TPServePrograms(model, devices=devices))
        ptp = progs.prepare_params(params)
        opts.sized_for(warm).build(model, params, programs=progs).run(warm)
        captured = progs.graph_stats.as_dict()
        eng, st, lt, peak = _tp_run(model, params, progs, trace(), opts,
                                    progs.devices)
        for k, v in lt.items():
            launches[k] += v
        got = {r.rid: r.generated for r in eng.finished}
        # page 0 is the null page: padding and masked rows write there,
        # in an order no one reads, so it is left out
        pools = {n: all(
            torch.equal(piece[:, 1:].to(want.device), want[:, 1:])
            and piece.shape[-2] == cfg.n_kv_heads // tp
            for piece, want in zip(getattr(eng.cache, n).shards,
                                   getattr(base.cache, n).chunk(tp, -2)))
            for n in ("k_pages", "v_pages")}
        pool_bytes = [p.nbytes for p in eng.cache.k_pages.shards]
        dispatch = _tp_dispatches(model, params, progs, ptp)
        # the trace's graphs: captures and replays past the warm-up's
        trace_graphs = progs.graph_stats.as_dict()
        trace_graphs = {
            "held": eng.compiled.graphs(),
            "segments": {n: sorted({g.n_segments for g in getattr(
                eng.compiled, n)._graphs.values()})
                for n in ("decode", "chunk", "verify", "fused")},
            **{k: {n: c - captured[k].get(n, 0) for n, c in v.items()}
               for k, v in trace_graphs.items() if k != "capture_s"},
            "capture_s": trace_graphs["capture_s"] - captured["capture_s"]}
        # the host's share of the trace's wall in the replays: the
        # segments' graph launches against the gathers' copies
        host = trace_graphs["host_s"]
        trace_graphs["host_share_of_wall"] = {
            k: v / st["wall_s"] for k, v in host.items()}
        trace_graphs["host_ms_per_replay"] = {
            k: 1e3 * v / max(sum(trace_graphs["replays"].values()), 1)
            for k, v in host.items()}
        graph_logits = _tp_graph_logits(model, progs, ptp)
        gates = {
            "streams_equal_tp1": got == streams,
            "slots_reused": eng._admit_counter == base._admit_counter
            > opts.batch,
            "dispatch_counters_equal_tp1": all(st[k] == st1[k]
                                               for k in counters),
            "pools_equal_tp1_slices": all(pools.values()),
            "pool_bytes_one_tp_th": all(
                b * tp == base.cache.k_pages.nbytes for b in pool_bytes),
            "launches_tp_times_tp1": all(
                lt[k] == tp * l1[k] and (l1[k] > 0 or k.endswith("_f32"))
                for k in PATH_COUNTERS),
            "program_logits_equal_tp1": all(
                d["equal_to_tp1"] and d["shards_equal"]
                for k, d in dispatch.items() if k != "pages_equal"),
            "dispatch_pools_equal": dispatch["pages_equal"],
            "engine_replays_graphs": sum(
                trace_graphs["replays"].values()) > 0,
            "graph_logits_equal_eager": all(
                d["logits_equal"] and d["pools_equal"]
                for k, d in graph_logits.items() if k != "replays")}
        readings[tp] = {"tok_per_s": st["tok_per_s"], "wall_s": st["wall_s"],
                        "peak_mem_gb_per_card": peak, "launches": lt,
                        "kv_pool_gb_per_shard": 2 * pool_bytes[0] / 1e9,
                        "heads_per_shard": [cfg.n_heads // tp,
                                            cfg.n_kv_heads // tp],
                        "d_ff_per_shard": cfg.d_ff // tp,
                        "dispatch": dispatch, "graphs": trace_graphs,
                        "graph_equals_eager": graph_logits,
                        "gates": gates}
        failures += [f"tp {tp}: {k}" for k, v in gates.items() if not v]
        del eng, progs, ptp
        gc.collect()
    rec = {"phase": "tp", "arch": cfg.name, "layers": cfg.n_layers,
           "H": cfg.n_heads, "KVH": cfg.n_kv_heads, "d_ff": cfg.d_ff,
           "requests": TP_REQUESTS, "prompt_len": PROMPT_LEN, "gen": GEN,
           "batch": opts.batch, "admissions": base._admit_counter,
           "spec_k": opts.spec_k, "fused": opts.fused,
           "n_pages": opts.n_pages, "by_tp": readings, "plans": plans,
           "note": {tp: "a card a shard" if p["card_a_shard"] else
                    "shards co-located on one card time-share it: no "
                    "tensor-parallel speed-up is measured"
                    for tp, p in plans.items()},
           "seconds": time.perf_counter() - t0, "card": nvidia_smi_line()}
    emit(rec)
    if failures:
        fail(f"tp [{cfg.name}]: gates failed: {failures}")
    del base, model, params, one
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_tp():
    """Tensor-parallel serving (``TP_RUNS``), a card a shard where there
    are enough cards, else every shard named ``cuda:0``.  Returns the
    path kernels' launches summed over the tp-way engines' traces."""
    total = dict.fromkeys(PATH_COUNTERS, 0)
    t0 = time.perf_counter()
    for name, tps in TP_RUNS:
        for k, n in _serve_tp(name, tps).items():
            total[k] += n
    emit({"phase": "tp", "seconds": time.perf_counter() - t0,
          "launches": total})
    return total


# ------------------------------------------------------------ families
def _family_config(name):
    """(FULL config as run on the card, its cuts as {key: [published,
    run]}): deepseek-moe at DEEPSEEK_CAPACITY, a depth of FAMILY_LAYERS
    where it names one; every width as published."""
    import dataclasses
    from repro_torch import configs
    cfg = configs.get(name)
    run, reduced = cfg, {}
    if name in FAMILY_LAYERS:
        run = dataclasses.replace(run, n_layers=FAMILY_LAYERS[name])
        reduced["n_layers"] = [cfg.n_layers, FAMILY_LAYERS[name]]
    if cfg.moe is not None:
        run = dataclasses.replace(run, moe=dataclasses.replace(
            cfg.moe, capacity_factor=DEEPSEEK_CAPACITY))
        reduced["capacity_factor"] = [cfg.moe.capacity_factor,
                                      DEEPSEEK_CAPACITY]
    return run, reduced


def _family_launch_gates(model, gen: int) -> dict:
    """What one lockstep run (a prefill, then gen - 1 decode steps)
    launches at the least.  These families do not page, so a decode
    step's attention runs the flash kernel at one query row
    (``components.flash_decode_attention``): flash once an attention
    layer at prefill and at every step (whisper: its encoder layers
    once, its decoder's self- and cross-attention at prefill and at
    every step), paged never; the dataflow GEMM once a projection at
    prefill and once a projection a step."""
    cfg, steps = model.cfg, gen - 1
    if cfg.is_encoder_decoder:
        flash = cfg.n_encoder_layers + 2 * cfg.n_layers * (1 + steps)
    else:
        attn = sum(k in ("attn", "local_attn") for k in cfg.layer_kinds)
        flash = attn * (1 + steps)
    return {"flash_attention": flash, "paged_attention": 0,
            "gemm_dataflow": _n_products(model)
            + _n_products(model, decode=True) * steps}


def _with_tokens(model, batch, tokens):
    """``batch`` with ``tokens`` (B, S') in place of its prompt: text
    M-RoPE positions to S', and, for a local-attention stack, the tokens
    padded with id 0 to a multiple of the window (the reference's
    S % window contract; causality keeps the padding out of every
    earlier position)."""
    import torch
    import torch.nn.functional as F
    cfg = model.cfg
    if "local_attn" in cfg.layer_kinds:
        tokens = F.pad(tokens, (0, -tokens.shape[1] % cfg.local_window))
    out = dict(batch, tokens=tokens.contiguous())
    if "mrope_positions" in batch:
        B, S = tokens.shape
        out["mrope_positions"] = torch.arange(
            S, dtype=torch.int32, device=tokens.device)[None, None].expand(
                B, 3, S)
    return out


def _rescore_family(model, params, batch, tokens) -> dict:
    """Each generated token against a teacher-forced whole ``apply`` of
    prompt + tokens[:, :-1]: within TAU of the best f32 logit at its
    position (logits only at the generated positions)."""
    import torch
    plen, gen = batch["tokens"].shape[1], tokens.shape[1]
    ctx = torch.cat([batch["tokens"], tokens[:, :-1]], 1)
    with torch.no_grad():
        h = model.apply(params, _with_tokens(model, batch, ctx),
                        want_hidden=True)[:, plen - 1:plen - 1 + gen]
        logits = model.logits(params, h)
    chosen = logits.gather(-1, tokens.long()[..., None])[..., 0]
    gap = logits.max(-1).values - chosen
    return {"tau": TAU, "max_gap": float(gap.max()),
            "mean_gap": float(gap.mean()),
            "logit_std": float(logits.std()),
            "teacher_forced_argmax_match": float(
                (logits.argmax(-1) == tokens).float().mean()),
            "finite": torch_isfinite(logits)}


def _decode_extends_prefill(model, params, batch, tokens) -> dict:
    """decode_step(prefill(x), t) against apply(x + t) at position S on
    EXTEND_ROWS rows, t each row's first generated token: within
    EXTEND_TOL (the reference's ``test_decode_step_extends_consistently``)."""
    import torch
    x = {k: v[:EXTEND_ROWS].contiguous() for k, v in batch.items()}
    t = tokens[:EXTEND_ROWS, :1].contiguous()
    S = x["tokens"].shape[1]
    with torch.no_grad():
        _, cache = model.prefill(params, x, max_len=S + 1)
        got, _ = model.decode_step(params, cache, t)
        ext = _with_tokens(model, x, torch.cat([x["tokens"], t], 1))
        want = model.logits(params, model.apply(params, ext,
                                                want_hidden=True)[:, S])
    err, ok = max_err(got, want, EXTEND_TOL, EXTEND_TOL)
    d = (got - want).abs()
    return {"rows": EXTEND_ROWS, "max_abs_err": err, "tol": EXTEND_TOL,
            "ok": ok, "diff_std": float(d.std()),
            "beyond_tol": int((d > EXTEND_TOL + EXTEND_TOL * want.abs()
                               ).sum()),
            "compared": d.numel()}


def _scan_forms(model, params, batch, tokens) -> dict:
    """A reading for a stack with RG-LRU or RWKV6 blocks: the prompt's
    recurrence against the decode step's, at full width.
    * ``layer0_f32``: the first recurrent layer's recurrence over the
      prompt on that layer's own input (all FAMILY_ROWS rows), f32
      outputs before any rounding: the prefill's form (RG-LRU: the
      associative scan; RWKV6: the reference's chunked WKV) against the
      decode step's operations token by token; max |difference| and
      max |output|.
    RWKV6 only (its prefill runs step by step unless ``wkv_prefill=
    "chunked"``), the two forms through the whole model:
    * ``bf16_*``: the served model: the largest logit difference over
      the last SCAN_LAST prompt positions of SCAN_ROWS rows, and decode
      extends prefill (EXTEND_TOL) after a chunked prefill;
    * ``f32_*``: the same difference in an f32 model on the same seed's
      weights before the bf16 cast, and the bf16 model's distance from
      it."""
    import dataclasses
    import torch
    from repro_torch.models import build_model
    from repro_torch.models import rglru as R
    from repro_torch.models import rwkv6 as W
    from repro_torch.models.components import linear
    cfg, dev = model.cfg, model.device
    x = {k: v[:SCAN_ROWS].contiguous() for k, v in batch.items()}
    out = {"rows": SCAN_ROWS, "positions": SCAN_LAST}

    def last_logits(m, p):
        h = m.apply(p, x, want_hidden=True)[:, -SCAN_LAST:]
        return m.logits(p, h)

    with torch.no_grad():
        tok = batch["tokens"]
        kind, _, lp, _ = next(b for b in model._blocks(params)
                           if b[0] in ("rglru", "rwkv"))
        h = model._norm(lp["ln1"], model._embed(params, tok))
        mix = lp["mix"]
        if kind == "rglru":
            u, _ = R.causal_conv1d(linear(h, mix["w_in"]), mix["conv_w"],
                                   mix["conv_b"])
            u = u.float()
            prompt = R.rglru_scan(mix, u)[0]
            steps, hs = [], torch.zeros_like(u[:, 0])
            for t in range(u.shape[1]):
                o, hs = R.rglru_step(mix, u[:, t:t + 1], hs)
                steps.append(o)
            steps = torch.cat(steps, 1)
        else:
            r, k, v, lw, u, _ = W.wkv_inputs(mix, h, cfg)
            prompt = W.wkv_chunked(r, k, v, lw, u)[0]
            steps = W.wkv_scan(r, k, v, lw, u)[0]
        out["layer0_f32"] = {
            "kind": kind, "rows": tok.shape[0],
            "max_abs_diff": float((prompt - steps).abs().max()),
            "max_abs_out": float(steps.abs().max())}
        del prompt, steps
        if kind == "rwkv":
            chunked = build_model(cfg, device=dev, wkv_prefill="chunked")
            s16 = last_logits(model, params)
            out["bf16_step_vs_chunked"] = float(
                (s16 - last_logits(chunked, params)).abs().max())
            out["bf16_chunked_decode_extends_prefill"] = (
                _decode_extends_prefill(chunked, params, batch,
                                        tokens)["max_abs_err"])
            cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
            m32 = build_model(cfg32, device=dev)
            p32 = m32.init(seed=0)
            s32 = last_logits(m32, p32)
            out["f32_step_vs_chunked"] = float((s32 - last_logits(
                build_model(cfg32, device=dev, wkv_prefill="chunked"),
                p32)).abs().max())
            out["bf16_step_vs_f32_step"] = float((s16 - s32).abs().max())
            out["f32_logit_std"] = float(s32.std())
            del p32
    return out


def _producers(params) -> dict:
    """The producer the dataflow GEMM's bf16 pipeline takes for each
    bf16 projection of the probed layers (``_probe_layers``), with the
    rows of a fresh activation."""
    import torch
    from repro_torch.kernels.gemm_dataflow import ops as gd_ops
    out = {}
    for layer, tree in _probe_layers(params):
        stack = [((layer,), tree)]
        while stack:
            path, node = stack.pop()
            for k, w in node.items():
                if isinstance(w, dict):
                    stack.append((path + (k,), w))
                elif w.dtype == torch.bfloat16 and w.dim() >= 2:
                    w2 = w[0] if w.dim() == 3 else w
                    x = torch.empty(8, w2.shape[0], dtype=w.dtype,
                                    device=w.device)
                    out["/".join(path + (k,))] = (
                        "tma" if gd_ops.producer_for(x, w2) == gd_ops.TMA
                        else "cp_async")
    return out


def _serve_family(name: str, prompt_len: int) -> dict:
    """One lockstep-only family at full widths on the card: seeded random
    init with the projections stored bf16 as they are drawn, a warm-up,
    the ``--naive`` loop on FAMILY_ROWS prompts of the reference's
    synthetic batch for GEN tokens, then its gates (every row finished,
    the TAU re-score, decode extends prefill, the row-bits gate, the
    launch counts) and readings (peaks, tok/s, each row against the
    same prompt alone through ``greedy_generate``).  Returns the path
    kernels' launches of the measured run."""
    import torch
    from repro_torch import configs
    from repro_torch.launch.serve import run_naive, synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves
    from repro_torch.serve import ServePrograms, greedy_generate
    from repro_torch.serve.step import projection_cast
    t0 = time.perf_counter()
    cfg, reduced = _family_config(name)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed=0, cast=projection_cast(model.dtype))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = _peak_gb()
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = synthetic_batch(cfg, FAMILY_ROWS, prompt_len, device="cuda")
    with torch.no_grad():
        run_naive(model, params, {k: v[:1] for k, v in batch.items()}, 3)
        torch.cuda.reset_peak_memory_stats()
        _launches_reset()
        run = run_naive(model, params, batch, GEN)
        launches = _launches_read()
        peak_gb = _peak_gb()
        tokens = run["tokens"]
        # the same loop eagerly, and one graphed step's logits
        eager = run_naive(model, params, batch, GEN,
                          programs=ServePrograms(model, graphs=False))
        lock = {"tokens_equal": torch.equal(eager["tokens"], tokens),
                "graphs": {k: run[k] for k in ("decode_s",
                                               "decode_tok_per_s",
                                               "graph_stats")},
                "eager": {k: eager[k] for k in ("decode_s",
                                                "decode_tok_per_s")},
                "logits": _lockstep_logits(
                    model, params, {k: v[:EXTEND_ROWS].contiguous()
                                    for k, v in batch.items()},
                    tokens[:EXTEND_ROWS])}
        del eager
        alone = [torch.equal(greedy_generate(
            model, params, {k: v[b:b + 1] for k, v in batch.items()}, GEN,
            cache_len=prompt_len + GEN)[0], tokens[b])
            for b in range(FAMILY_ROWS)]
    want = _family_launch_gates(model, GEN)
    rescore = _rescore_family(model, params, batch, tokens)
    extend = _decode_extends_prefill(model, params, batch, tokens)
    row_bits = _row_bits(model, params)
    scan_forms = (_scan_forms(model, params, batch, tokens)
                  if {"rglru", "rwkv"} & set(cfg.layer_kinds) else None)
    full = configs.get(name)
    gates = {
        "all_finished": tuple(tokens.shape) == (FAMILY_ROWS, GEN),
        "rescore_within_tau": rescore["finite"]
        and rescore["max_gap"] <= TAU,
        "decode_extends_prefill": extend["ok"],
        "row_bits_stable": not any(row_bits.values()),
        "lockstep_graph_equals_eager": _lockstep_held(lock),
        **{f"{k}_launched": launches[k] >= want[k]
           and (launches[k] > 0 or want[k] == 0) for k in want}}
    emit({"phase": "families", "arch": cfg.name, "family": cfg.family,
          "layers": cfg.n_layers, "layers_full": full.n_layers,
          "reduced": reduced, "n_params": n_params,
          "n_params_full": full.n_params(), "d_model": cfg.d_model,
          "H": cfg.n_heads, "KVH": cfg.n_kv_heads, "Dh": cfg.head_dim,
          "rows": FAMILY_ROWS, "prompt_len": prompt_len, "gen": GEN,
          "init_s": init_s, "init_peak_mem_gb": init_peak_gb,
          "peak_mem_gb": peak_gb, "prefill_s": run["prefill_s"],
          "decode_s": run["decode_s"], "tok_per_s": run["tok_per_s"],
          "decode_tok_per_s": run["decode_tok_per_s"],
          "batched_equals_alone": sum(alone),
          "launches": launches, "launches_expected": want,
          "rescore": rescore, "decode_extends_prefill": extend,
          "lockstep_graph_equals_eager": lock,
          "row_bits": row_bits, "scan_forms": scan_forms,
          "producers": _producers(params),
          "gates": gates, "seconds": time.perf_counter() - t0,
          "card": nvidia_smi_line()})
    bad = [k for k, ok in gates.items() if not ok]
    if bad:
        fail(f"families [{cfg.name}]: gates failed: {bad}")
    return launches


def phase_families():
    """The five lockstep-only families one after the other on the card
    (each freed before the next).  Returns the path kernels' launches
    summed over their measured runs."""
    import gc
    import torch
    total = dict.fromkeys(PATH_COUNTERS, 0)
    t0 = time.perf_counter()
    for name, prompt_len in FAMILIES_ON_CARD:
        for k, n in _serve_family(name, prompt_len).items():
            total[k] += n
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "families", "seconds": time.perf_counter() - t0,
          "launches": total})
    return total


def _train_launches() -> dict:
    """The training path's launch counters: the flash forward's, the
    flash backward's (one a call of the dQ + dK/dV pair) and the
    dataflow GEMM's."""
    fa, gd = _ops("flash_attention"), _ops("gemm_dataflow")
    return {"flash_attention": fa.launches,
            "flash_attention_bwd": fa.bwd_launches,
            "gemm_dataflow": gd.launches,
            "gemm_dataflow_f32": gd.launches_f32}


def _train_launches_reset() -> None:
    fa, gd = _ops("flash_attention"), _ops("gemm_dataflow")
    fa.launches = fa.bwd_launches = gd.launches = gd.launches_f32 = 0


def _train_launch_gates(model, steps: int) -> dict:
    """What ``steps`` train steps launch (remat "full"): each layer's
    flash forward twice (the forward and the backward's recompute) and
    its backward once; every projection's GEMM four times (forward,
    recompute, dX, dW), ``_n_products`` a forward, but a dead product
    (``_n_dead``: the FFN's down projection) three, as the recompute
    does not form its output."""
    L = model.cfg.n_layers
    return {"flash_attention": 2 * L * steps,
            "flash_attention_bwd": L * steps,
            "gemm_dataflow": (4 * _n_products(model) - _n_dead(model))
            * steps}


def _train_launcher(root) -> tuple:
    """Run 1: ``launch.train.main`` at full width.  Returns (its record,
    its launches)."""
    import contextlib
    import torch
    from repro_torch import configs
    from repro_torch.launch import train as launch_train
    from repro_torch.models.lm import DecoderLM
    ckpt = root / "run1"
    argv = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--ckpt-every",
            str(TRAIN_CKPT_EVERY), "--log-every", "1", "--device", "cuda",
            "--ckpt-dir", str(ckpt)]
    torch.cuda.reset_peak_memory_stats()
    _train_launches_reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):   # its log lines
        drv = launch_train.main(argv)
    wall = time.perf_counter() - t0
    launches = _train_launches()
    log = drv.metrics_log
    step_s = sorted(m["wall_s"] for m in log)
    median = step_s[len(step_s) // 2]
    want = _train_launch_gates(DecoderLM(configs.get(TRAIN_ARCH),
                                         device="meta"), TRAIN_STEPS)
    events = [(e.kind, e.step) for e in drv.events]
    gates = {
        "every_step_logged": [m["step"] for m in log] == list(
            range(TRAIN_STEPS)),
        "loss_finite_positive": all(np.isfinite(m["loss"]) and m["loss"] > 0
                                    for m in log),
        "grad_norm_finite_positive": all(
            np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0
            for m in log),
        "no_restart": not any(k == "restart" for k, _ in events),
        "checkpoints": all(
            (ckpt / f"step_{s:09d}" / "manifest.json").is_file()
            and ("checkpoint", s) in events
            for s in range(TRAIN_CKPT_EVERY, TRAIN_STEPS + 1,
                           TRAIN_CKPT_EVERY)),
        "launches": all(launches[k] == n for k, n in want.items())}
    rec = {"phase": "train", "run": "launcher", "argv": argv,
           "losses": [m["loss"] for m in log],
           "grad_norms": [m["grad_norm"] for m in log],
           "step_ms": [m["wall_s"] * 1e3 for m in log],
           "step_ms_median": median * 1e3,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / median,
           "peak_mem_gb": _peak_gb(), "wall_s": wall, "events": events,
           "launches": launches, "launches_expected": want,
           "launches_per_step": {k: n / TRAIN_STEPS
                                 for k, n in launches.items()},
           "gates": gates, "card": nvidia_smi_line()}
    emit(rec)
    bad = [k for k, ok in gates.items() if not ok]
    if bad:
        fail(f"train [launcher]: gates failed: {bad}")
    return rec, launches


def _train_resume(root) -> dict:
    """Run 2: the same 10 steps through ``TrainDriver`` with a fault
    injected once at step TRAIN_FAULT_AT; it restores the checkpoint of
    step TRAIN_CKPT_EVERY and must end with every parameter and
    optimizer leaf equal (``torch.equal``) to run 1's step-10
    checkpoint."""
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import load_reference_checkpoint
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models.lm import DecoderLM
    from repro_torch.runtime import DriverConfig, TrainDriver
    from repro_torch.train import OptConfig, init_opt_state, make_train_step
    from repro_torch.tree import tree_items
    cfg = configs.get(TRAIN_ARCH)
    model = DecoderLM(cfg, device="cuda")
    pipe = SyntheticPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ)
    faults = {TRAIN_FAULT_AT}

    def hook(step):
        if step in faults:
            faults.discard(step)
            raise RuntimeError("injected fault")
    params = model.init(seed=0)              # the launcher's init
    drv = TrainDriver(
        DriverConfig(total_steps=TRAIN_STEPS, ckpt_dir=str(root / "run2"),
                     ckpt_every=TRAIN_CKPT_EVERY, log_every=1),
        make_train_step(model, cfg, opt=OptConfig()),
        lambda s: pipe.device_batch(s, model.device), fault_hook=hook)
    t0 = time.perf_counter()
    p, o = drv.run(params, init_opt_state(params))
    wall = time.perf_counter() - t0
    del params
    ref, step = load_reference_checkpoint(root / "run1", device="cuda")
    differ = [("/".join(path)) for path, leaf in
              tree_items({"params": p, "opt": o})
              if not torch.equal(leaf, _get(ref, path))]
    events = [(e.kind, e.step) for e in drv.events]
    restarts = [s for k, s in events if k == "restart"]
    gates = {"one_restart_at_fault": restarts == [TRAIN_FAULT_AT],
             "restored_checkpoint": drv.metrics_log[TRAIN_FAULT_AT]["step"]
             == TRAIN_CKPT_EVERY,
             "reference_step": step == TRAIN_STEPS,
             "equal_to_uninterrupted": not differ}
    rec = {"phase": "train", "run": "resume", "fault_at": TRAIN_FAULT_AT,
           "events": events, "wall_s": wall,
           "leaves": sum(1 for _ in tree_items({"params": p, "opt": o})),
           "leaves_differing": differ[:8], "gates": gates}
    emit(rec)
    bad = [k for k, ok in gates.items() if not ok]
    if bad:
        fail(f"train [resume]: gates failed: {bad}")
    return rec


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _train_grads() -> dict:
    """qwen3-0.6b at full width, GRAD_LAYERS layers, B GRAD_BATCH x
    TRAIN_SEQ: one loss and gradient on the card, where every leaf must
    get a gradient that is not all zero, and the same on the CPU through
    the port's plain path (same params, same batch): the loss within
    GRAD_LOSS_TOL and each leaf's gradient within GRAD_REL_L2 relative
    L2."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models.lm import DecoderLM
    from repro_torch.train.step import make_loss_fn
    from repro_torch.tree import tree_items, tree_map
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH), n_layers=GRAD_LAYERS)
    out = {}
    batch = SyntheticPipeline(cfg, GRAD_BATCH, TRAIN_SEQ).batch_for_step(0)
    params = None
    for dev in ("cuda", "cpu"):
        model = DecoderLM(cfg, device=dev)
        if params is None:
            params = model.init(seed=1)
        p = tree_map(lambda t: t.detach().to(dev).requires_grad_(), params)
        leaves = [t for _, t in tree_items(p)]
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        loss, _ = make_loss_fn(model, cfg)(p, b)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out[dev] = (float(loss.detach()),
                    [None if g is None else g.float().cpu() for g in grads],
                    time.perf_counter() - t0)
    names = ["/".join(path) for path, _ in tree_items(params)]
    card, cpu = out["cuda"][1], out["cpu"][1]
    missing = [n for n, g in zip(names, card)
               if g is None or not bool(g.ne(0).any())]
    rel = {n: float((a - b).norm() / b.norm().clamp(min=1e-30))
           for n, a, b in zip(names, card, cpu) if a is not None}
    worst = max(rel, key=rel.get)
    gates = {"every_leaf_has_a_gradient": not missing,
             "loss_close_to_cpu": abs(out["cuda"][0] - out["cpu"][0])
             <= GRAD_LOSS_TOL,
             "grads_close_to_cpu": max(rel.values()) <= GRAD_REL_L2}
    rec = {"phase": "train", "run": "gradients", "layers": GRAD_LAYERS,
           "B": GRAD_BATCH, "S": TRAIN_SEQ, "loss_card": out["cuda"][0],
           "loss_cpu": out["cpu"][0],
           "loss_abs_diff": abs(out["cuda"][0] - out["cpu"][0]),
           "loss_tol": GRAD_LOSS_TOL, "grad_rel_l2": rel,
           "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst_leaf": worst,
           "grad_rel_l2_tol": GRAD_REL_L2, "leaves_without_gradient": missing,
           "card_s": out["cuda"][2], "cpu_s": out["cpu"][2], "gates": gates}
    emit(rec)
    bad = [k for k, ok in gates.items() if not ok]
    if bad:
        fail(f"train [gradients]: gates failed: {bad}")
    return rec


def _train_remat() -> dict:
    """qwen3-0.6b at full width, GRAD_LAYERS layers, B GRAD_BATCH x
    TRAIN_SEQ: one loss and gradient on the card with ``remat="full"``
    (each layer under ``components.remat``, its dead last product not
    formed in the recompute) and with ``remat="none"``: the loss and
    every leaf ``torch.equal``; the GEMM launches 4 a product less one
    a dead product, and 3 a product without remat; each run's peak."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models.lm import DecoderLM
    from repro_torch.train.step import make_loss_fn
    from repro_torch.tree import tree_items, tree_map
    base = dataclasses.replace(configs.get(TRAIN_ARCH), n_layers=GRAD_LAYERS)
    batch = SyntheticPipeline(base, GRAD_BATCH, TRAIN_SEQ).device_batch(
        0, "cuda")
    params = DecoderLM(base, device="cuda").init(seed=1)
    names = ["/".join(path) for path, _ in tree_items(params)]
    out = {}
    for remat in ("full", "none"):
        cfg = dataclasses.replace(base, remat=remat)
        model = DecoderLM(cfg, device="cuda")
        p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
        leaves = [t for _, t in tree_items(p)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _train_launches_reset()
        t0 = time.perf_counter()
        loss, _ = make_loss_fn(model, cfg)(p, batch)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        out[remat] = {"loss": loss.detach(), "grads": grads,
                      "s": time.perf_counter() - t0, "peak_mem_gb": _peak_gb(),
                      "launches": _train_launches()}
        del p, leaves, loss
    full, none = out["full"], out["none"]
    differ = [n for n, a, b in zip(names, full["grads"], none["grads"])
              if not torch.equal(a, b)]
    n_prod, n_dead = _n_products(model), _n_dead(model)
    gates = {"loss_equal": torch.equal(full["loss"], none["loss"]),
             "grads_equal": not differ,
             "launches_full": full["launches"]["gemm_dataflow"]
             == 4 * n_prod - n_dead,
             "launches_none": none["launches"]["gemm_dataflow"]
             == 3 * n_prod}
    rec = {"phase": "train", "run": "remat", "layers": GRAD_LAYERS,
           "B": GRAD_BATCH, "S": TRAIN_SEQ, "loss": float(full["loss"]),
           "leaves": len(names), "leaves_differing": differ,
           "products": n_prod, "dead_products": n_dead,
           **{f"{k}_{r}": out[r][k] for r in out
              for k in ("launches", "peak_mem_gb", "s")},
           "gates": gates, "card": nvidia_smi_line()}
    emit(rec)
    bad = [k for k, ok in gates.items() if not ok]
    if bad:
        fail(f"train [remat]: gates failed: {bad}")
    return rec


def _train_overfit() -> dict:
    """qwen3-0.6b at full width learns one fixed batch: OVERFIT_STEPS
    steps with ``OptConfig(warmup_steps=1)``; the last loss must be
    below the first.  The last PROFILE_STEPS steps run under the
    profiler (device time by kernel group, the device's idle share)."""
    from repro_torch import configs
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models.lm import DecoderLM
    from repro_torch.train import OptConfig, init_opt_state, make_train_step
    cfg = configs.get(TRAIN_ARCH)
    model = DecoderLM(cfg, device="cuda")
    opt = OptConfig(warmup_steps=1)
    step = make_train_step(model, cfg, opt=opt)
    batch = SyntheticPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ).device_batch(
        0, "cuda")
    params = model.init(seed=2)
    state = init_opt_state(params, opt)
    losses = []

    def steps(n):
        nonlocal params, state
        for _ in range(n):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
    steps(OVERFIT_STEPS - PROFILE_STEPS)
    # the last steps under the profiler: where a step's time goes
    prof = _device_profile(lambda: steps(PROFILE_STEPS))
    gates = {"learns": losses[-1] < losses[0],
             "finite": all(np.isfinite(x) for x in losses)}
    rec = {"phase": "train", "run": "overfit", "steps": OVERFIT_STEPS,
           "lr": opt.lr, "losses": losses, "first": losses[0],
           "last": losses[-1], "gates": gates,
           "profile": {"steps": PROFILE_STEPS, **prof}}
    emit(rec)
    bad = [k for k, ok in gates.items() if not ok]
    if bad:
        fail(f"train [overfit]: gates failed: {bad}")
    return rec


def _train_storage() -> dict:
    """qwen3-0.6b at full width, B TRAIN_BATCH x TRAIN_SEQ, STORAGE_STEPS
    steps from one init with the parameters stored f32 (AdamW as the
    launcher runs it) and stored bf16 (``param_dtype="bfloat16"``, the
    reference's ``OPT_SETTINGS``, with ``keep_master``: an f32 master
    in the optimizer state): step ms (median, host clock after the
    loss's sync) and the peak GB of each.  Gate: every loss finite."""
    import dataclasses
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models.lm import DecoderLM
    from repro_torch.train import OptConfig, init_opt_state, make_train_step
    from repro_torch.tree import tree_leaves
    runs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(configs.get(TRAIN_ARCH), param_dtype=dtype)
        model = DecoderLM(cfg, device="cuda")
        opt = OptConfig(keep_master=dtype != "float32")
        step = make_train_step(model, cfg, opt=opt)
        batch = SyntheticPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ).device_batch(
            0, "cuda")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = model.init(seed=0)
        state = init_opt_state(params, opt)
        param_gb = sum(t.nbytes for t in tree_leaves(params)) / 1e9
        state_gb = sum(t.nbytes for t in tree_leaves(state)) / 1e9
        losses, times = [], []
        for _ in range(STORAGE_STEPS):
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
        times = sorted(times[1:])
        runs[dtype] = {"keep_master": opt.keep_master, "losses": losses,
                       "step_ms_median": times[len(times) // 2] * 1e3,
                       "param_gb": param_gb, "opt_state_gb": state_gb,
                       "peak_mem_gb": _peak_gb(),
                       "leaf_dtypes": sorted({str(t.dtype) for t in
                                              tree_leaves(params)})}
        del model, params, state, step, batch
    gates = {"losses_finite": all(np.isfinite(x) for r in runs.values()
                                  for x in r["losses"])}
    rec = {"phase": "train", "run": "param_dtype", "arch": TRAIN_ARCH,
           "B": TRAIN_BATCH, "S": TRAIN_SEQ, "steps": STORAGE_STEPS,
           "runs": runs, "gates": gates, "card": nvidia_smi_line()}
    emit(rec)
    if not gates["losses_finite"]:
        fail(f"train [param_dtype]: a loss is not finite: {runs}")
    return rec


def phase_train():
    """qwen3-0.6b's training path at full width on the card: the
    launcher (10 steps, checkpoints at 5 and 10, launch gates), the
    resumed run after an injected fault (bit for bit), every leaf's
    gradient against the CPU's plain path, a grad step under remat bit
    for bit the one without it, an overfit run, and the
    step with parameters stored bf16 beside f32.  Returns the training
    kernels' launches in the launcher's run."""
    import gc
    import shutil
    import tempfile
    import torch
    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        _, launches = _train_launcher(root)
        gc.collect()
        torch.cuda.empty_cache()
        _train_resume(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for run in (_train_grads, _train_remat, _train_overfit, _train_storage):
        gc.collect()
        torch.cuda.empty_cache()
        run()
    emit({"phase": "train", "seconds": time.perf_counter() - t0,
          "launches": launches})
    return launches


# ------------------------------------------------------ train_families
def _family_train_gates(model) -> dict:
    """What one train step launches (remat "full"): every attention
    layer's flash forward twice (the forward and the backward's
    recompute) and its backward once, whisper's encoder and its
    decoder's self- and cross-attention each; every projection's GEMM
    four times (forward, recompute, dX, dW), except whisper's
    cross-attention K/V of the encoder output, computed once outside
    the decoder's blocks as in the reference, and each block's dead
    last product (``_n_dead``: the dense FFN's down projection, the
    shared expert's), whose output the recompute does not form (three
    each); the f32 products (routers, RG-LRU's gates, RWKV6's decay
    LoRA) among them."""
    from repro_torch.models.base import flatten_specs
    cfg = model.cfg
    if cfg.is_encoder_decoder:
        n_attn = cfg.n_encoder_layers + 2 * cfg.n_layers
        outside = 2 * cfg.n_layers
    else:
        n_attn = sum(k in ("attn", "local_attn") for k in cfg.layer_kinds)
        outside = 0
    f32 = 0
    for path, spec in flatten_specs(model.param_specs()):
        if spec.f32:
            f32 += spec.init_shape[0] if path[0] == "layers" else 1
    return {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn,
            "gemm_dataflow": 4 * _n_products(model) - outside
            - _n_dead(model),
            "gemm_dataflow_f32": 4 * f32}


def _family_launcher(name, B, S, root) -> dict:
    """``launch.train.main`` at full size for FAMILY_TRAIN_STEPS steps
    (a new batch a step, a checkpoint at the end): every step logged,
    finite positive losses and gradient norms, the launches a step."""
    import contextlib
    from repro_torch.launch import train as launch_train
    argv = ["--arch", name, "--batch", str(B), "--seq", str(S), "--steps",
            str(FAMILY_TRAIN_STEPS), "--ckpt-every", str(FAMILY_TRAIN_STEPS),
            "--log-every", "1", "--device", "cuda", "--ckpt-dir",
            str(root / name)]
    _train_launches_reset()
    with contextlib.redirect_stdout(sys.stderr):   # its log lines
        drv = launch_train.main(argv)
    launches = _train_launches()
    log = drv.metrics_log
    step_ms = [m["wall_s"] * 1e3 for m in log]
    return {"argv": argv, "losses": [m["loss"] for m in log],
            "step_ms": step_ms, "launches": launches,
            "gates": {"every_step_logged": [m["step"] for m in log]
                      == list(range(FAMILY_TRAIN_STEPS)),
                      "loss_finite_positive": all(
                          np.isfinite(m["loss"]) and m["loss"] > 0
                          for m in log),
                      "grad_norm_finite_positive": all(
                          np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0
                          for m in log)}}


def _route_as(card_ids=None):
    """Wrap ``components.moe_route`` so that this device's expert ids are
    kept in call order and, given ``card_ids``, its i-th call routes as
    the card's i-th call did (``card_ids[i]``, in its choice order, gated
    by this device's probabilities at those ids, normalized as the
    router normalizes its top k).  Returns (own ids, undo)."""
    import torch
    from repro_torch.models import components as C
    orig, own = C.moe_route, []

    def route(p, xf, cfg):
        probs, topw, topi = orig(p, xf, cfg)
        own.append(topi.detach().cpu())
        if card_ids is None:
            return probs, topw, topi
        ids = card_ids[len(own) - 1].to(topi.device)
        w = torch.gather(probs, 1, ids)
        if cfg.moe.normalize_router:
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        return probs, w, ids
    C.moe_route = route
    return own, lambda: setattr(C, "moe_route", orig)


def _family_grads(name, layers, B, S) -> dict:
    """One loss and gradient of ``name`` at ``layers`` layers (one block
    pattern), full widths, on the card and on the CPU's plain path from
    the same parameters and batch: the loss within GRAD_LOSS_TOL, each
    leaf within GRAD_REL_L2 relative L2, and every leaf whose CPU
    gradient is not all zero has a card gradient that is not.  An MoE's
    router sits on near ties at a random init (64 experts' probabilities
    all near 1/64), so bf16 activations that differ in the last place
    between the devices flip some tokens' sixth choice: the CPU runs the
    card's expert ids (``_route_as``), and how many tokens the CPU's own
    router would have sent elsewhere is reported."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models import build_model
    from repro_torch.train.step import make_loss_fn
    from repro_torch.tree import tree_items, tree_map
    full = configs.get(name)
    cuts = dict(FAMILY_GRAD_CUTS.get(name, {}))
    if layers is not None:
        cuts.update(n_layers=layers, **(
            {"n_encoder_layers": layers} if full.is_encoder_decoder else {}))
    cfg = dataclasses.replace(full, **cuts)
    pipe = SyntheticPipeline(cfg, B, S)
    out, params = {}, None
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev)
        if params is None:
            params = model.init(seed=1)
        p = tree_map(lambda t: t.detach().to(dev).requires_grad_(), params)
        leaves = [t for _, t in tree_items(p)]
        routes, undo = _route_as(out["cuda"][3] if dev == "cpu" else None)
        t0 = time.perf_counter()
        try:
            loss, aux = make_loss_fn(model, cfg)(p, pipe.device_batch(0, dev))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            undo()
        out[dev] = (float(loss.detach()), float(aux["moe_aux"].detach()),
                    [None if g is None else g.float().cpu() for g in grads],
                    routes, time.perf_counter() - t0)
        del p, leaves, grads, loss, model
        if dev == "cuda":
            params = tree_map(lambda t: t.cpu(), params)
            gc.collect()
            torch.cuda.empty_cache()
    names = ["/".join(path) for path, _ in tree_items(params)]
    card, cpu = out["cuda"][2], out["cpu"][2]
    live = [n for n, g in zip(names, cpu) if g is not None and
            bool(g.ne(0).any())]
    missing = [n for n, g in zip(names, card) if n in live and
               (g is None or not bool(g.ne(0).any()))]
    rel = {n: float((a - b).norm() / b.norm().clamp(min=1e-30))
           for n, a, b in zip(names, card, cpu) if n in live}
    worst = max(rel, key=rel.get)
    routes = None
    if cfg.moe is not None:
        pairs = list(zip(out["cuda"][3], out["cpu"][3]))
        routes = {"calls": len(pairs), "cpu_ran_card_ids": True,
                  "own_ids_all_equal": all(torch.equal(a, b)
                                           for a, b in pairs),
                  "tokens": int(pairs[0][0].shape[0]),
                  "tokens_routed_elsewhere_by_cpu": [
                      int((a != b).any(1).sum()) for a, b in pairs]}
    gates = {"every_live_leaf_has_a_gradient": not missing,
             "loss_close_to_cpu": abs(out["cuda"][0] - out["cpu"][0])
             <= GRAD_LOSS_TOL,
             "grads_close_to_cpu": rel[worst] <= GRAD_REL_L2}
    return {"layers": cfg.n_layers, "B": B, "S": S,
            "reduced": {k: [getattr(full, k), v] for k, v in cuts.items()},
            "loss_card": out["cuda"][0], "loss_cpu": out["cpu"][0],
            "moe_aux_card": out["cuda"][1], "moe_aux_cpu": out["cpu"][1],
            "loss_abs_diff": abs(out["cuda"][0] - out["cpu"][0]),
            "loss_tol": GRAD_LOSS_TOL, "grad_rel_l2_max": rel[worst],
            "grad_rel_l2_worst_leaf": worst, "grad_rel_l2_tol": GRAD_REL_L2,
            "leaves": len(names), "live_leaves": len(live),
            "leaves_without_gradient": missing, "expert_ids": routes,
            "card_s": out["cuda"][4], "cpu_s": out["cpu"][4],
            "gates": gates}


def _train_family(name, layers, B, S, cmp_layers, cmp_S, via_launcher,
                  root) -> dict:
    """One architecture's training at full widths on the card: through
    the launcher (whisper), then FAMILY_TRAIN_STEPS steps of
    ``make_train_step`` on one batch from a seeded init (the loss must
    fall), the first step run twice from the same (params, opt_state,
    batch) (every leaf ``torch.equal``), the launch counts against
    ``_family_train_gates``, the peak memory; then the gradients against
    the CPU's plain path (``_family_grads``).  Returns the kernels'
    launches of the measured run."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models import build_model
    from repro_torch.train import OptConfig, init_opt_state, make_train_step
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    full = configs.get(name)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    reduced = {} if layers is None else {"n_layers": [full.n_layers,
                                                      layers]}
    launcher = (_family_launcher(name, B, S, root) if via_launcher
                else None)
    model = build_model(cfg, device="cuda")
    want = _family_train_gates(model)
    opt = OptConfig(warmup_steps=1)
    step = make_train_step(model, cfg, opt=opt)
    batch = SyntheticPipeline(cfg, B, S).device_batch(0, "cuda")
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed=0)
    state = init_opt_state(params, opt)
    n_params = sum(t.numel() for t in tree_leaves(params))
    # the first step twice from the same state: the first's leaves to
    # the host (the card holds one step's trees at a time)
    first = step(params, state, batch)
    host = [t.cpu() for t in tree_leaves({"p": first[0], "s": first[1]})]
    del first
    _train_launches_reset()
    losses, step_s = [], []
    for i in range(FAMILY_TRAIN_STEPS):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - ts)
        if i == 0:
            again = tree_leaves({"p": params, "s": state})
            differ = sum(not torch.equal(a, b.cpu())
                         for a, b in zip(host, again))
            del host, again
    launches = _train_launches()
    peak = _peak_gb()
    del params, state, m, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    median = sorted(step_s[1:])[len(step_s[1:]) // 2]
    grads = _family_grads(name, cmp_layers, min(B, GRAD_BATCH), cmp_S)
    gates = {
        "loss_finite": all(np.isfinite(x) for x in losses),
        "loss_falls": losses[-1] < losses[0],
        "two_steps_equal": differ == 0,
        **{f"{k}_launches": launches[k] == n * FAMILY_TRAIN_STEPS
           for k, n in want.items()},
        **{f"gradients_{k}": ok for k, ok in grads["gates"].items()}}
    if launcher is not None:
        per = {k: n * FAMILY_TRAIN_STEPS for k, n in want.items()}
        gates.update({f"launcher_{k}": ok
                      for k, ok in launcher["gates"].items()})
        gates["launcher_launches"] = launcher["launches"] == per
    rec = {"phase": "train_families", "arch": name, "family": cfg.family,
           "layers": cfg.n_layers, "layers_full": full.n_layers,
           "reduced": reduced, "n_params": n_params,
           "n_params_full": full.n_params(), "d_model": cfg.d_model,
           "B": B, "S": S, "steps": FAMILY_TRAIN_STEPS, "lr": opt.lr,
           "losses": losses, "step_ms": [t * 1e3 for t in step_s],
           "step_ms_median": median * 1e3, "tokens_per_s": B * S / median,
           "peak_mem_gb": peak, "launches": launches,
           "launches_per_step_expected": want, "leaves_differing": differ,
           "gradients": grads, "launcher": launcher, "gates": gates,
           "seconds": time.perf_counter() - t0, "card": nvidia_smi_line()}
    emit(rec)
    bad = [k for k, ok in gates.items() if not ok]
    if bad:
        fail(f"train_families [{name}]: gates failed: {bad}")
    return launches


def phase_train_families():
    """The MoE and the lockstep-only families train on the card
    (FAMILY_TRAIN), one after the other, each freed before the next.
    Returns the training kernels' launches summed over the measured
    runs."""
    import shutil
    import tempfile
    import torch
    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_families_"))
    total = {}
    try:
        for spec in FAMILY_TRAIN:
            for k, n in _train_family(*spec, root).items():
                total[k] = total.get(k, 0) + n
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "train_families", "seconds": time.perf_counter() - t0,
          "launches": total,
          "not_on_card": {"llama4-scout-17b-a16e": "trains on the CPU "
                          "smoke config only: one layer's 2.0 B expert "
                          "parameters with the 2.07 B untied embedding "
                          "and head need ~77 GB with Adam"}})
    return total



# --------------------------------------------------------------- dryrun
def _dry_launches() -> dict:
    """Every path kernel's launch counter (the training path's and the
    paged kernel's)."""
    return {**_train_launches(),
            "paged_attention": _ops("paged_attention").launches}


def _dry_launches_reset() -> None:
    _train_launches_reset()
    _ops("paged_attention").launches = 0


def _dry_predict(cfg, shape) -> dict:
    """The dry run's prediction of one step of ``cfg`` at ``shape`` (a
    ``ShapeSpec``) on one device: every kernel's launches, the argument
    bytes, the traced peak."""
    from repro_torch.launch import dryrun
    fn, args, _ = dryrun.build_step(cfg.name, shape, None, cfg=cfg)
    out, counter, secs = dryrun.trace(fn, args)
    mem = dryrun.memory_of(args, out, counter.peak)
    launches = dict.fromkeys(_dry_launches(), 0)
    launches.update({k: v["launches"]
                     for k, v in counter.cost.kernels.items()})
    return {"launches": launches, "argument_bytes": mem["argument_bytes"],
            "peak_bytes": mem["per_device_bytes"], "trace_s": secs,
            "flops": counter.cost.flops, "bytes": counter.cost.bytes}


def _dry_measure(run, args) -> dict:
    """``run()`` on the card once more after a warm call: each kernel's
    launches, the bytes of the argument tensors ``args`` (a list), and
    ``max_memory_allocated`` over the call."""
    import torch
    warm = run()
    del warm
    gc.collect()
    torch.cuda.synchronize()
    arg = sum(t.numel() * t.element_size() for t in args)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _dry_launches_reset()
    out = run()
    torch.cuda.synchronize()
    rec = {"launches": _dry_launches(), "argument_bytes": arg,
           "allocated_before_bytes": base,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del out
    return rec


def _dry_anchor(kind: str) -> dict:
    """One anchor: the dry run's prediction of a qwen3-0.6b FULL train
    step (B TRAIN_BATCH x S TRAIN_SEQ) or decode step (B TRAIN_BATCH,
    cache DRYRUN_PROMPT + GEN) against the same step on the card."""
    import torch
    from repro_torch import configs
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models import build_model
    from repro_torch.train import OptConfig, init_opt_state, make_train_step
    from torch.utils._pytree import tree_flatten
    cfg = configs.get(DRYRUN_ARCH)
    B, cap = TRAIN_BATCH, DRYRUN_PROMPT + GEN
    shape = (ShapeSpec("anchor_train", TRAIN_SEQ, B, "train")
             if kind == "train" else ShapeSpec("anchor_decode", cap, B,
                                               "decode"))
    want = _dry_predict(cfg, shape)
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    if kind == "train":
        opt = OptConfig(keep_master=cfg.param_dtype != "float32")
        state = init_opt_state(params, opt)
        batch = SyntheticPipeline(cfg, B, TRAIN_SEQ).device_batch(0, "cuda")
        step = make_train_step(model, cfg, opt=opt)
        got = _dry_measure(lambda: step(params, state, batch),
                           tree_flatten((params, state, batch))[0])
        del state, batch, step
    else:
        batch = SyntheticPipeline(cfg, B, DRYRUN_PROMPT).device_batch(
            0, "cuda")
        with torch.no_grad():
            logits, cache = model.prefill(params, batch["tokens"],
                                          max_len=cap)
            tok = logits.argmax(-1)[:, None].int()
            got = _dry_measure(
                lambda: model.decode_step(params, cache, tok)[0],
                tree_flatten((params, cache["layers"], tok))[0])
        del batch, logits, cache, tok
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    rel = abs(want["peak_bytes"] - got["peak_bytes"]) / got["peak_bytes"]
    gates = {"launches_equal": want["launches"] == got["launches"],
             "argument_bytes_equal": want["argument_bytes"]
             == got["argument_bytes"],
             "peak_within_tol": rel <= DRYRUN_PEAK_TOL}
    return {"kind": kind, "B": B,
            "seq": TRAIN_SEQ if kind == "train" else cap,
            "predicted": want, "measured": got,
            "predicted_peak_gb": want["peak_bytes"] / 1e9,
            "measured_peak_gb": got["peak_bytes"] / 1e9,
            "peak_rel_err": rel, "peak_tol": DRYRUN_PEAK_TOL,
            "gates": gates}


def _dry_cells_start():
    """Start the production cells' traces (DRYRUN_CELLS), one subprocess
    each on the CPU (a dry run touches no card), so that they run while
    the card runs the phases before ``dryrun``.  Returns (the processes,
    their directory, a ``stop`` that ends them and removes it, also
    registered to run at exit)."""
    import atexit
    import shutil
    import tempfile
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    env = {**os.environ, "PYTHONPATH": str(SRC), "CUDA_VISIBLE_DEVICES": ""}
    procs = []
    for arch, shape, over in DRYRUN_CELLS:
        with open(root / f"{arch}__{shape}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", "single",
                 "--out", str(root),
                 *(a for k, v in over.items() for a in ("--set",
                                                         f"{k}={v}"))],
                env=env, stdout=log, stderr=subprocess.STDOUT))

    def stop():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    atexit.register(stop)
    return procs, root, stop


def _dry_cells_finish(procs, root) -> list:
    """Wait for the production cells' traces; each cell's readings and
    its gates: model FLOPs a device exactly 6 N_active tokens / 256, and
    the traced FLOPs a device and the GEMM's share at or below
    DRYRUN_FLOPS within DRYRUN_FLOPS_TOL."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import apply_overrides
    out = []
    for (arch, shape, over), proc in zip(DRYRUN_CELLS, procs):
        try:
            proc.wait(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"dryrun [{arch} {shape}]: no result in "
                 f"{DRYRUN_TIMEOUT_S} s of the phase")
        if proc.returncode != 0:
            log = (root / f"{arch}__{shape}.log").read_text()
            fail(f"dryrun [{arch} {shape}]: exit {proc.returncode}: "
                 f"{log[-2000:]}")
        res = json.loads((root / f"{arch}__{shape}__single.json")
                         .read_text())
        s = configs.shape_by_name(shape)
        want = 6 * apply_overrides(configs.get(arch), over).n_active_params() \
            * s.global_batch * s.seq_len / 256
        mem, roof = res["memory"], res["roofline"]
        flops = res["loop_aware"]["flops"]
        gemm = res["kernels"]["gemm_dataflow"]["flops"]
        cap = [f * (1 + DRYRUN_FLOPS_TOL) for f in DRYRUN_FLOPS[arch, shape]]
        out.append({
            "arch": arch, "shape": shape, "overrides": over,
            "mesh": [16, 16],
            "world": res["world"], "n_micro": res["n_micro"],
            "per_device_gb": mem["per_device_bytes"] / 1e9,
            "argument_gb": mem["argument_bytes"] / 1e9,
            "fits": mem["fits"], "bottleneck": roof["bottleneck"],
            "step_time_s": roof["step_time_s"],
            "model_fraction": roof["model_fraction"],
            "useful_ratio": res["model_flops"]["useful_ratio"],
            "trace_s": res["lower_s"],
            "flops": flops, "gemm_flops": gemm,
            "flops_cap": cap[0], "gemm_flops_cap": cap[1],
            "launches": {k: v["launches"]
                         for k, v in res["kernels"].items()},
            "gates": {"model_flops_exact":
                      res["model_flops"]["per_device"] == want,
                      "flops_within_cap": flops <= cap[0],
                      "gemm_flops_within_cap": gemm <= cap[1]}})
    return out


def phase_dryrun(cells):
    """The dry run's predictions held against the card (``_dry_anchor``:
    a train step and a decode step of qwen3-0.6b FULL), and the
    production cells traced beside them (``cells``, from
    ``_dry_cells_start``)."""
    t0 = time.perf_counter()
    procs, root, stop = cells
    try:
        anchors = [_dry_anchor("train"), _dry_anchor("decode")]
        readings = _dry_cells_finish(procs, root)
    finally:
        stop()
    rec = {"phase": "dryrun", "anchors": anchors, "cells": readings,
           "seconds": time.perf_counter() - t0, "card": nvidia_smi_line()}
    emit(rec)
    bad = [f"{a['kind']}:{k}" for a in anchors for k, ok in
           a["gates"].items() if not ok] + [
        f"{c['arch']}:{k}" for c in readings
        for k, ok in c["gates"].items() if not ok]
    if bad:
        fail(f"dryrun: gates failed: {bad}")


# ----------------------------------------------------------------- mesh
def _mesh_refs(root) -> dict:
    """The single-device runs the mesh is held to, on the card in this
    process, written to ``root`` for the ranks: qwen3's loss and every
    leaf's gradient (and the grad step's launches); deepseek's final
    hidden states at C = T and at its own capacity factor, and its loss
    and gradients at its own; qwen3's prefill and MESH_DECODE_STEPS
    decode steps (the tokens fed and each step's logits).  Returns the
    readings."""
    import torch
    from repro_torch import configs
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models.lm import DecoderLM
    from repro_torch.train.step import make_grad_fn
    from repro_torch.tree import tree_items
    out = {}

    def grads(model, cfg, params, batch, name):
        _train_launches_reset()
        _mesh_sync()
        t0 = time.perf_counter()
        loss, _, g = make_grad_fn(model, cfg)(params, batch)
        _mesh_sync()
        out[f"{name}_grad_s"] = time.perf_counter() - t0
        out[f"{name}_launches"] = _train_launches()
        out[f"{name}_loss"] = float(loss)
        return {"/".join(p): t.float().cpu() for (p, _), t in
                zip(tree_items(params), g)}

    cfg = configs.get(MESH_ARCH)
    model = DecoderLM(cfg, device=MESH_DEVICE)
    params = model.init(seed=MESH_SEED)
    batch = SyntheticPipeline(cfg, MESH_B, MESH_S).device_batch(0, MESH_DEVICE)
    torch.save(grads(model, cfg, params, batch, "train"),
               root / "train_ref.pt")
    del params, batch
    _mesh_free()

    cfg = _mesh_moe_config()
    model = DecoderLM(cfg, device=MESH_DEVICE)
    params = model.init(seed=MESH_SEED)
    batch = SyntheticPipeline(cfg, MESH_MOE_B, MESH_S).device_batch(0, MESH_DEVICE)
    ref = {}
    for name, cf in _mesh_capacities(cfg):
        m = DecoderLM(_mesh_cf(cfg, cf), device=MESH_DEVICE)
        ids, undo = _route_as()
        with torch.no_grad():
            ref[name] = m.apply(params, batch, want_hidden=True).cpu()
        undo()
        ref[f"ids_{name}"] = ids
    ids, undo = _route_as()
    torch.save(grads(model, cfg, params, batch, "moe"),
               root / "moe_grads_ref.pt")
    undo()
    ref["ids_grads"] = ids
    torch.save(ref, root / "moe_ref.pt")
    del params, batch, ref
    _mesh_free()

    cfg = configs.get(MESH_ARCH)
    model = DecoderLM(cfg, device=MESH_DEVICE)
    params = model.init(seed=MESH_SEED)
    tokens = SyntheticPipeline(cfg, MESH_B, MESH_S).device_batch(0, MESH_DEVICE)["tokens"]
    with torch.no_grad():
        last, cache = model.prefill(params, tokens,
                                    max_len=MESH_S + MESH_DECODE_STEPS)
        fed, logits = [], []
        tok = last.argmax(-1)
        for _ in range(MESH_DECODE_STEPS):
            fed.append(tok)
            lg, cache = model.decode_step(params, cache, tok[:, None])
            logits.append(lg.cpu())
            tok = lg.argmax(-1)
    torch.save({"last": last.cpu(), "fed": torch.stack(fed).cpu(),
                "logits": torch.stack(logits)}, root / "decode_ref.pt")
    del params, cache
    _mesh_free()

    from repro_torch.models import build_model
    for arch, layers, B, S in MESH_FAMILIES:
        cfg = _mesh_family_config(arch, layers)
        model = build_model(cfg, device=MESH_DEVICE)
        params = model.init(seed=MESH_SEED)
        batch = SyntheticPipeline(cfg, B, S).device_batch(0, MESH_DEVICE)
        _mesh_sync(reset_peak=True)
        torch.save(grads(model, cfg, params, batch, arch),
                   root / f"{arch}_grads_ref.pt")
        out[f"{arch}_peak_gb"] = _mesh_peak_gb()
        with torch.no_grad():
            last, cache = model.prefill(
                params, _mesh_prompt(batch),
                max_len=S + MESH_FAMILY_DECODE_STEPS)
            fed, logits = [], []
            tok = last.argmax(-1)
            for _ in range(MESH_FAMILY_DECODE_STEPS):
                fed.append(tok)
                lg, cache = model.decode_step(params, cache, tok[:, None])
                logits.append(lg.cpu())
                tok = lg.argmax(-1)
        torch.save({"fed": torch.stack(fed).cpu(),
                    "logits": torch.stack(logits)},
                   root / f"{arch}_decode_ref.pt")
        del params, batch, cache
        _mesh_free()
    return out


def _mesh_family_config(arch, layers):
    import dataclasses
    from repro_torch import configs
    cfg = configs.get(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _mesh_prompt(batch) -> dict:
    """A training batch's prompt: its tokens (and whisper's frames)."""
    return {k: batch[k] for k in ("tokens", "frames") if k in batch}


def _mesh_free() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _mesh_sync(reset_peak: bool = False) -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        if reset_peak:
            torch.cuda.reset_peak_memory_stats()


def _mesh_peak_gb() -> float:
    import torch
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated() / 1e9


def _mesh_moe_config():
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get(MESH_MOE), n_layers=MESH_MOE_LAYERS)


def _mesh_cf(cfg, cf):
    import dataclasses
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def _mesh_capacities(cfg):
    """(name, capacity factor): C = T (no token dropped anywhere, so
    the expert-parallel forward is the single-device one), and the
    configuration's own (per-shard capacity may drop other tokens)."""
    m = cfg.moe
    return (("C=T", m.n_experts / m.top_k), ("own", m.capacity_factor))


def _mesh_grad_check(mesh, grads, shardings, ref) -> dict:
    """Each leaf's gradient shard against the same shard of a reference:
    the single device's whole gradients (``ref`` their path, read
    mapped), or another step's shards on this rank (``ref`` a list in
    ``grads``' order).  The squared difference and the reference's
    squared norm summed over the elements this rank owns (a replicated
    leaf counted once), added over every rank; rank 0's result holds
    each leaf's relative L2."""
    import torch
    from repro_torch.sharding.collectives import all_reduce
    from repro_torch.train.optimizer import _owned
    from repro_torch.tree import tree_items
    whole = None if isinstance(ref, list) else torch.load(ref, mmap=True)
    names = ["/".join(p) for p, _ in tree_items(shardings)]
    owned = _owned(shardings, mesh)
    sums = torch.zeros(len(names), 3, dtype=torch.float64,
                       device=mesh.device)
    for i, ((_, spec), g, name) in enumerate(zip(tree_items(shardings),
                                                 grads, names)):
        if not owned[i]:
            continue
        want = (ref[i] if whole is None
                else mesh.shard(whole[name], spec)).to(g.device).double()
        got = g.double()
        sums[i, 0] = torch.sum((got - want) ** 2)
        sums[i, 1] = torch.sum(want ** 2)
        sums[i, 2] = float(bool(got.ne(0).any()))
    sums = all_reduce(sums, mesh, mesh.axis_names)
    rel = {n: float(torch.sqrt(s[0] / s[1].clamp(min=1e-300)))
           for n, s in zip(names, sums.cpu())}
    worst = max(rel, key=rel.get)
    return {"grad_rel_l2_max": rel[worst], "grad_rel_l2_worst_leaf": worst,
            "leaves_without_gradient": [n for n, s in zip(names, sums.cpu())
                                        if s[2] == 0 and s[1] > 0]}


def _mesh_rank(rank, world, shape, job, root, devices, backend) -> None:
    """One rank of a mesh run on ``devices[rank]`` over ``backend``;
    NCCL raises on a collective that waits MESH_TIMEOUT_S (async error
    handling) rather than blocking."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.sharding import collectives
    init_distributed(backend, rank=rank, world_size=world,
                     init_method=f"file://{root}/store_{job}",
                     timeout_s=MESH_TIMEOUT_S)
    # make_mesh makes the rank's card the current device, which the
    # syncs and peaks below read
    mesh = make_mesh(shape, ("data", "model"), devices=devices)
    collectives.TIMING = True
    _mesh_sync(reset_peak=True)
    rec = {"job": job, "rank": rank, "mesh": list(shape),
           "device": str(mesh.device), "backend": mesh.backend}
    {"train": _mesh_train, "moe_decode": _mesh_moe_decode,
     "restore": _mesh_restore}[job](mesh, root, rec)
    rec["peak_gb"] = _mesh_peak_gb()
    (root / f"{job}_{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


def _mesh_model(cfg, mesh):
    """The model and the rank's shards of the seeded parameters."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.sharding import tree_shardings
    from repro_torch.sharding.spmd import shard_tree
    model = build_model(cfg, device=mesh.device)
    sh = tree_shardings(model.param_specs(), mesh)
    params = shard_tree(model.init(seed=MESH_SEED), sh, mesh)
    _mesh_free()
    return model, params, sh


def _mesh_grads(mesh, model, cfg, params, batch, sh, ref, rec, name,
                tally: bool = False):
    """The grad step's loss, launches, seconds and leaves against
    ``ref`` (``_mesh_grad_check``); with ``tally`` also the step's own
    collectives (the check's all-reduce left out)."""
    import torch
    from repro_torch.sharding import collectives
    from repro_torch.train.step import make_grad_fn
    _train_launches_reset()
    if tally:
        collectives.reset_stats()
    with mesh:
        _mesh_sync()
        t0 = time.perf_counter()
        loss, _, grads = make_grad_fn(model, cfg)(params, batch)
        _mesh_sync()
        rec[f"{name}_grad_s"] = time.perf_counter() - t0
        if tally:
            rec[f"{name}_collectives"] = collectives.stats()
        rec[f"{name}_launches"] = _train_launches()
        rec[f"{name}_loss"] = float(loss)
        rec.update({f"{name}_{k}": v for k, v in _mesh_grad_check(
            mesh, grads, sh, ref).items()})
    return grads


def _mesh_sp(mesh, cfg, B, rec, name, ids=None) -> None:
    """``cfg`` on the mesh at B x MESH_S, one set of parameters and one
    batch: the grad step under the default rules, then under SP_RULES
    (the MoE routed as ``ids`` in both, the single device's), each
    followed by a forward alone; records each step's loss, launches,
    seconds, peak and collectives, the forward's collectives, and the
    SP step's leaves against the default step's (``_mesh_grad_check``;
    the default step's gradients wait on the host, so each step's peak
    counts its own), and the pair's seconds, model and comparison
    included."""
    import torch
    from repro_torch.data import SyntheticPipeline
    from repro_torch.sharding import collectives
    from repro_torch.sharding.rules import (DEFAULT_RULES, SP_RULES,
                                            set_active_rules)
    from repro_torch.train.step import make_grad_fn
    t_pair = time.perf_counter()
    model, params, sh = _mesh_model(cfg, mesh)
    batch = SyntheticPipeline(cfg, B, MESH_S).device_batch(0, mesh=mesh)
    grads = {}
    for tag, rules in (("default", DEFAULT_RULES), ("sp", SP_RULES)):
        key = f"{name}_{tag}"
        set_active_rules(rules)
        try:
            _, undo = _route_as(ids)
            try:
                _train_launches_reset()
                collectives.reset_stats()
                _mesh_sync(reset_peak=True)
                t0 = time.perf_counter()
                with mesh:
                    loss, _, grads[tag] = make_grad_fn(model, cfg)(params,
                                                                   batch)
                _mesh_sync()
            finally:
                undo()
            rec[f"{key}_grad_s"] = time.perf_counter() - t0
            if tag == "default":
                grads[tag] = [g.cpu() for g in grads[tag]]
            rec[f"{key}_loss"] = float(loss)
            rec[f"{key}_launches"] = _train_launches()
            rec[f"{key}_peak_gb"] = _mesh_peak_gb()
            rec[f"{key}_collectives"] = collectives.stats()
            collectives.reset_stats()
            with mesh, torch.no_grad():
                model.apply(params, batch, train=True, want_hidden=True)
            rec[f"{key}_forward_collectives"] = collectives.stats()
        finally:
            set_active_rules(DEFAULT_RULES)
    rec.update({f"{name}_sp_{k}": v for k, v in _mesh_grad_check(
        mesh, grads["sp"], sh, grads["default"]).items()})
    del params, grads
    _mesh_free()
    rec[f"{name}_sp_pair_s"] = time.perf_counter() - t_pair


def _mesh_train(mesh, root, rec) -> None:
    """(2, 2): qwen3-0.6b's loss and gradients, MESH_STEPS timed steps
    with the collectives' bytes and seconds, then a checkpoint of a
    MESH_CKPT_LAYERS-layer model saved from its shards (each file's
    shard equal to the rank's)."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.checkpoint.reader import read_leaf, read_manifest
    from repro_torch.data import SyntheticPipeline
    from repro_torch.sharding import collectives, tree_shardings
    from repro_torch.sharding.collectives import all_reduce
    from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                             init_opt_state, opt_state_specs)
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_items, tree_unflatten
    cfg = configs.get(MESH_ARCH)
    model, params, sh = _mesh_model(cfg, mesh)
    pipe = SyntheticPipeline(cfg, MESH_B, MESH_S)
    opt = OptConfig()
    state = init_opt_state(params, opt)
    step = make_train_step(model, cfg, opt=opt)
    collectives.reset_stats()
    rec["step_ms"], rec["losses"] = [], []
    with mesh:
        for s in range(MESH_STEPS):
            batch = pipe.device_batch(s, mesh=mesh)
            if s == 0:
                # the first step's gradient, held against the single
                # device's, then its AdamW update: the step's time is
                # the two parts' (the comparison left out)
                grads = _mesh_grads(mesh, model, cfg, params, batch, sh,
                                    root / "train_ref.pt", rec, "train")
                _mesh_sync()
                t0 = time.perf_counter()
                params, state, _ = adamw_update(
                    params, tree_unflatten(params, grads), state, opt,
                    shardings=sh)
                _mesh_sync()
                rec["step_ms"].append(rec["train_grad_s"] * 1e3
                                      + (time.perf_counter() - t0) * 1e3)
                rec["losses"].append(rec["train_loss"])
                del grads
                continue
            _mesh_sync()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            _mesh_sync()
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["losses"].append(float(m["loss"]))
    rec["collectives"] = collectives.stats()
    rec["peak_gb_train"] = _mesh_peak_gb()
    del params, state
    _mesh_free()

    cfg = dataclasses.replace(cfg, n_layers=MESH_CKPT_LAYERS)
    model, params, sh = _mesh_model(cfg, mesh)
    shardings = {"params": sh, "opt": tree_shardings(
        opt_state_specs(model.param_specs(), opt), mesh)}
    state = init_opt_state(params, opt)
    with mesh:
        params, state, _ = make_train_step(model, cfg, opt=opt)(
            params, state, pipe.device_batch(0, mesh=mesh))
        tree = {"params": params, "opt": state}
        ckpt = save_checkpoint(root / "ckpt", 1, tree, shardings=shardings)
        leaves = read_manifest(ckpt)["leaves"]
        bad = sum(not torch.equal(mesh.shard(read_leaf(ckpt, "__".join(p),
                                                       leaves["__".join(p)]),
                                             spec), t)
                  for (p, t), (_, spec) in zip(tree_items(tree),
                                               tree_items(shardings)))
        bad = int(all_reduce(torch.tensor(float(bad), device=mesh.device),
                             mesh, mesh.axis_names))
    rec["ckpt_leaves"] = len(leaves)
    rec["ckpt_files_unequal_to_shards"] = bad
    del params, state, tree
    _mesh_free()
    _mesh_sp(mesh, dataclasses.replace(configs.get(MESH_ARCH),
                                       n_layers=MESH_SP_LAYERS),
             MESH_B, rec, "qwen3")
    _mesh_family_train(mesh, root, rec)


def _mesh_family_train(mesh, root, rec) -> None:
    """(2, 2): each of MESH_FAMILIES' first-step loss and gradients
    against the single device's (the grad step's launches beside its),
    then its AdamW update, and a second, whole step: each step's ms,
    the peak, the collectives' bytes and seconds."""
    import torch
    from repro_torch.data import SyntheticPipeline
    from repro_torch.sharding import collectives
    from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                             init_opt_state)
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_unflatten
    opt = OptConfig()
    for arch, layers, B, S in MESH_FAMILIES:
        cfg = _mesh_family_config(arch, layers)
        model, params, sh = _mesh_model(cfg, mesh)
        pipe = SyntheticPipeline(cfg, B, S)
        state = init_opt_state(params, opt)
        step = make_train_step(model, cfg, opt=opt)
        _mesh_sync(reset_peak=True)
        collectives.reset_stats()
        step_ms, losses = [], []
        with mesh:
            grads = _mesh_grads(mesh, model, cfg, params,
                                pipe.device_batch(0, mesh=mesh), sh,
                                root / f"{arch}_grads_ref.pt", rec, arch)
            t0 = time.perf_counter()
            params, state, _ = adamw_update(
                params, tree_unflatten(params, grads), state, opt,
                shardings=sh)
            _mesh_sync()
            step_ms.append(rec[f"{arch}_grad_s"] * 1e3
                           + (time.perf_counter() - t0) * 1e3)
            losses.append(rec[f"{arch}_loss"])
            del grads
            for s in range(1, MESH_STEPS):
                batch = pipe.device_batch(s, mesh=mesh)
                _mesh_sync()
                t0 = time.perf_counter()
                params, state, m = step(params, state, batch)
                _mesh_sync()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m["loss"]))
        rec[f"{arch}_step_ms"] = step_ms
        rec[f"{arch}_losses"] = losses
        rec[f"{arch}_collectives"] = collectives.stats()
        rec[f"{arch}_peak_gb"] = _mesh_peak_gb()
        del params, state, step
        _mesh_free()


def _mesh_moe_decode(mesh, root, rec) -> None:
    """(1, 4): deepseek-moe's expert-parallel forward (16 of 64 experts a
    rank) at C = T and at its own capacity factor against the single
    device's, and its gradients; qwen3-0.6b's prefill and
    MESH_DECODE_STEPS lockstep decode steps on a cache split along its
    sequence over ``model``, each step's logits against the single
    device's."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models.lm import DecoderLM
    cfg = _mesh_moe_config()
    model, params, sh = _mesh_model(cfg, mesh)
    batch = SyntheticPipeline(cfg, MESH_MOE_B, MESH_S).device_batch(
        0, mesh=mesh)
    ref = torch.load(root / "moe_ref.pt", mmap=True)
    for name, cf in _mesh_capacities(cfg):
        # at C = T the single device's expert ids (a choice on a knife
        # edge of the router's bf16 input is not what is held here); at
        # the own capacity factor the mesh's own routing
        _, undo = _route_as(ref["ids_C=T"] if name == "C=T" else None)
        with mesh, torch.no_grad():
            h = DecoderLM(_mesh_cf(cfg, cf), device=mesh.device).apply(
                params, batch, want_hidden=True).float().cpu()
        undo()
        n = h.shape[0]
        want = ref[name][mesh.axis_index(mesh.data_axes()) * n:][:n].float()
        rec[f"moe_{name}_max_abs_err"] = float((h - want).abs().max())
        rec[f"moe_{name}_rel_l2"] = float((h - want).norm() / want.norm())
        rec[f"moe_{name}_close"] = float(np.mean(np.isclose(
            h.numpy(), want.numpy(), rtol=MESH_CLOSE_TOL,
            atol=MESH_CLOSE_TOL)))
        rec[f"moe_{name}_outside_allclose"] = float((~torch.isclose(
            h, want, rtol=ATOL, atol=ATOL)).float().mean())
    _, undo = _route_as(ref["ids_grads"])
    _mesh_grads(mesh, model, cfg, params, batch, sh,
                root / "moe_grads_ref.pt", rec, "moe")
    undo()
    del params
    _mesh_free()
    _mesh_sp(mesh, cfg, MESH_MOE_B, rec, "moe", ids=ref["ids_grads"])
    del ref

    cfg = configs.get(MESH_ARCH)
    model, params, sh = _mesh_model(cfg, mesh)
    ref = torch.load(root / "decode_ref.pt", mmap=True)
    tokens = SyntheticPipeline(cfg, MESH_B, MESH_S).device_batch(
        0, mesh=mesh)["tokens"]
    errs, rel, argmax, outside, times = [], [], [], [], []
    with mesh, torch.no_grad():
        last, cache = model.prefill(params, tokens,
                                    max_len=MESH_S + MESH_DECODE_STEPS)
        rec["decode_seq_shards"] = cache["seq_shards"]
        rec["prefill_max_abs_err"] = float(
            (last.cpu() - ref["last"]).abs().max())
        for t in range(MESH_DECODE_STEPS):
            _mesh_sync()
            t0 = time.perf_counter()
            lg, cache = model.decode_step(
                params, cache, ref["fed"][t].to(mesh.device)[:, None])
            _mesh_sync()
            times.append((time.perf_counter() - t0) * 1e3)
            got, want = lg.cpu(), ref["logits"][t]
            errs.append(float((got - want).abs().max()))
            rel.append(float((got - want).norm() / want.norm()))
            argmax.append(float((got.argmax(-1) == want.argmax(-1))
                                .float().mean()))
            outside.append(float((~torch.isclose(
                got, want, rtol=ATOL, atol=ATOL)).float().mean()))
    rec["decode_max_abs_err"] = max(errs)
    rec["decode_rel_l2_max"] = max(rel)
    rec["decode_argmax_equal_min"] = min(argmax)
    rec["decode_outside_allclose_max"] = max(outside)
    rec["decode_step_ms"] = float(np.median(times))
    del params, cache
    _mesh_free()
    _mesh_family_decode(mesh, root, rec)
    _mesh_uneven(mesh, root, rec)


def _mesh_uneven(mesh, root, rec) -> None:
    """(1, 4): MESH_UNEVEN's first grad step (MESH_FAMILIES' batch),
    whose heads ``model`` = 4 does not divide, so each rank computes its
    own run of whole heads (``spmd.rank_heads``), against the single
    device's gradients that ``_mesh_refs`` wrote for (2, 2); the step's
    collectives (for the dry run's tally) and its peak."""
    from repro_torch.data import SyntheticPipeline
    _, layers, B, S = next(f for f in MESH_FAMILIES if f[0] == MESH_UNEVEN)
    cfg = _mesh_family_config(MESH_UNEVEN, layers)
    model, params, sh = _mesh_model(cfg, mesh)
    _mesh_sync(reset_peak=True)
    _mesh_grads(mesh, model, cfg, params,
                SyntheticPipeline(cfg, B, S).device_batch(0, mesh=mesh), sh,
                root / f"{MESH_UNEVEN}_grads_ref.pt", rec, "uneven",
                tally=True)
    rec["uneven_peak_gb"] = _mesh_peak_gb()
    del params
    _mesh_free()


def _mesh_family_decode(mesh, root, rec) -> None:
    """(1, 4): each of MESH_FAMILIES' prefill on the mesh and
    MESH_FAMILY_DECODE_STEPS decode steps fed the single device's
    tokens, each step's logits against the single device's; the cache's
    leaves against the shards ``cache_specs`` places."""
    import numpy as np
    import torch
    from repro_torch.data import SyntheticPipeline
    from repro_torch.sharding import tree_shardings
    for arch, layers, B, S in MESH_FAMILIES:
        cfg = _mesh_family_config(arch, layers)
        model, params, _ = _mesh_model(cfg, mesh)
        ref = torch.load(root / f"{arch}_decode_ref.pt", mmap=True)
        batch = SyntheticPipeline(cfg, B, S).device_batch(0, mesh=mesh)
        rows = batch["tokens"].shape[0]
        first = mesh.axis_index(mesh.data_axes()) * rows
        _mesh_sync(reset_peak=True)
        rel, times = [], []
        with mesh, torch.no_grad():
            _, cache = model.prefill(
                params, _mesh_prompt(batch),
                max_len=S + MESH_FAMILY_DECODE_STEPS)
            specs = model.cache_specs(B, S + MESH_FAMILY_DECODE_STEPS)
            split = _mesh_cache_split(cache, specs, tree_shardings(
                specs, mesh), mesh)
            rec[f"{arch}_seq_shards"] = cache["seq_shards"]
            for t in range(MESH_FAMILY_DECODE_STEPS):
                _mesh_sync()
                t0 = time.perf_counter()
                lg, cache = model.decode_step(
                    params, cache,
                    ref["fed"][t][first:first + rows].to(mesh.device)[:, None])
                _mesh_sync()
                times.append((time.perf_counter() - t0) * 1e3)
                got = lg.float().cpu()
                want = ref["logits"][t][first:first + rows].float()
                rel.append(float((got - want).norm() / want.norm()))
        rec[f"{arch}_decode_rel_l2"] = rel
        rec[f"{arch}_decode_step_ms"] = float(np.median(times))
        rec[f"{arch}_cache_leaves"] = split[0]
        rec[f"{arch}_cache_leaves_misplaced"] = split[1]
        rec[f"{arch}_decode_peak_gb"] = _mesh_peak_gb()
        del params, cache, ref
        _mesh_free()


def _mesh_cache_split(cache, specs, shardings, mesh):
    """(leaves, paths of the cache tensors whose shape is not the shard
    of ``cache_specs`` that ``shardings`` places)."""
    from repro_torch.sharding.spmd import shard_shapes
    got = shard_shapes(cache, specs, shardings, mesh)
    return len(got), [path for path, shape, want in got if shape != want]


def _mesh_restore(mesh, root, rec) -> None:
    """(1, 2), the plan ``plan_elastic_mesh`` gives two ranks of a
    model-parallel-2 run: the (2, 2) run's checkpoint restored onto
    it, gathered back and held against every stored array."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.checkpoint.reader import read_leaf, read_manifest
    from repro_torch.sharding import tree_shardings
    from repro_torch.sharding.spmd import unshard_tree
    from repro_torch.train.optimizer import (OptConfig, init_opt_state,
                                             opt_state_specs)
    from repro_torch.tree import tree_items
    cfg = dataclasses.replace(configs.get(MESH_ARCH),
                              n_layers=MESH_CKPT_LAYERS)
    model, params, sh = _mesh_model(cfg, mesh)
    shardings = {"params": sh, "opt": tree_shardings(
        opt_state_specs(model.param_specs()), mesh)}
    like = {"params": params, "opt": init_opt_state(params)}
    with mesh:
        tree, step = restore_checkpoint(root / "ckpt", like,
                                        shardings=shardings)
        full = unshard_tree(tree, shardings, mesh)
    ckpt = root / "ckpt" / f"step_{step:09d}"
    leaves = read_manifest(ckpt)["leaves"]
    bad = [k for k, t in (("__".join(p), t) for p, t in tree_items(full))
           if not torch.equal(t.cpu(), read_leaf(ckpt, k, leaves[k]))]
    rec["restored_step"] = step
    rec["restored_leaves"] = len(leaves)
    rec["restored_unequal"] = bad


def _mesh_spawn(job, shape, root) -> list:
    """Run ``job`` on ``shape``'s ranks (torch.multiprocessing, placed by
    ``device_plan``); a rank that fails fails the phase, and so does a
    job that has not ended in MESH_TIMEOUT_S (its ranks killed: a rank
    that skips a collective the others issue would block them).
    Returns every rank's record."""
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import device_plan
    world = int(np.prod(shape))
    devices, backend = device_plan(world)
    t0 = time.perf_counter()
    try:
        ctx = mp.spawn(_mesh_rank, args=(world, tuple(shape), job, root,
                                         devices, backend),
                       nprocs=world, join=False)
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > MESH_TIMEOUT_S:
                for proc in ctx.processes:
                    proc.kill()
                fail(f"mesh [{job}]: the ranks ran past {MESH_TIMEOUT_S} s")
    except Exception as e:                           # noqa: BLE001
        fail(f"mesh [{job}]: a rank failed: {e}")
    recs = [json.loads((root / f"{job}_{r}.json").read_text())
            for r in range(world)]
    for r in recs:
        r["spawn_s"] = time.perf_counter() - t0
    return recs


def _mesh_dry_tally() -> dict:
    """The dry run's tally of the qwen3 SP pair's grad step (MESH_SP_LAYERS
    layers, B x S MESH_B x MESH_S, one microbatch) under the default
    rules and under SP_RULES on a dry (2, 2) mesh, and (``uneven``) of
    MESH_UNEVEN's grad step on a dry (1, 4) mesh: by kind, the calls and
    input bytes a live rank 0 must tally, and the bytes on the wire."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.dryrun import collective_tally
    from repro_torch.launch.mesh import make_dry_mesh
    from repro_torch.sharding.rules import RULE_VARIANTS
    cfg = dataclasses.replace(configs.get(MESH_ARCH), n_layers=MESH_SP_LAYERS)
    mesh = make_dry_mesh(MESH_TRAIN_SHAPE, ("data", "model"))
    shape = ShapeSpec("mesh_sp", MESH_S, MESH_B, "train")
    out = {tag: collective_tally(cfg, shape, mesh, RULE_VARIANTS[tag])
           for tag in ("default", "sp")}
    _, layers, B, S = next(f for f in MESH_FAMILIES if f[0] == MESH_UNEVEN)
    out["uneven"] = collective_tally(
        _mesh_family_config(MESH_UNEVEN, layers),
        ShapeSpec("mesh_uneven", S, B, "train"),
        make_dry_mesh(MESH_MOE_SHAPE, ("data", "model")))
    return out


def _mesh_tally_reading(live: dict, dry: dict) -> dict:
    """By kind: rank 0's calls, input bytes and seconds (``TIMING``: the
    device drained before and after each call), its GB/s of input and
    of wire bytes, and the dry run's wire bytes and its predicted
    seconds for them (over ``cost.HW.ici_link_bw``, no overlap)."""
    from repro_torch.cost import HW
    out = {}
    for kind, rec in live.items():
        d = dry.get(kind, {})
        wire = d.get("wire_bytes", 0.0)
        out[kind] = {**rec, "dry_calls": d.get("calls"),
                     "dry_bytes": d.get("bytes"), "wire_bytes": wire,
                     "gb_per_s": rec["bytes"] / rec["s"] / 1e9
                     if rec["s"] else None,
                     "wire_gb_per_s": wire / rec["s"] / 1e9
                     if rec["s"] else None,
                     "dry_predicted_s": wire / HW.ici_link_bw}
    return out


def _tally_counts(tally: dict) -> dict:
    return {k: (v["calls"], v["bytes"]) for k, v in tally.items()}


def _mesh_sum_launches(recs, key) -> dict:
    out = {}
    for r in recs:
        for k, n in r[key].items():
            out[k] = out.get(k, 0) + n
    return out


def phase_mesh():
    """The training mesh: ranks of ``torch.distributed`` as processes,
    placed by ``device_plan`` (a card each over NCCL where there are
    enough cards, else every one on this card over gloo: NCCL refuses
    two ranks on one device), the kernels built once before the spawn.
    The qwen3 SP pair's collectives on rank 0 are held equal to the dry
    run's tally of the same step.  Returns the launches of the mesh's
    grad steps, summed over the ranks."""
    import shutil
    import tempfile
    import torch
    from repro_torch.launch.mesh import device_plan
    from repro_torch.runtime import plan_elastic_mesh
    from repro_torch.sharding import spmd
    t0 = time.perf_counter()
    shape, _ = plan_elastic_mesh(2, model_parallel=MESH_TRAIN_SHAPE[1])
    plans = {}
    for job, mesh_shape in (("train", MESH_TRAIN_SHAPE),
                            ("moe_decode", MESH_MOE_SHAPE),
                            ("restore", shape)):
        devices, backend = device_plan(int(np.prod(mesh_shape)))
        plans[job] = {"mesh": list(mesh_shape), "backend": backend,
                      "devices": [str(d) for d in devices]}
    emit({"phase": "mesh", "plan": plans,
          "cards_visible": torch.cuda.device_count()})
    dry = _mesh_dry_tally()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        refs = _mesh_refs(root)
        train = _mesh_spawn("train", MESH_TRAIN_SHAPE, root)
        moe = _mesh_spawn("moe_decode", MESH_MOE_SHAPE, root)
        restore = _mesh_spawn("restore", shape, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0, m0, s0 = train[0], moe[0], restore[0]
    gates = {
        "train_loss_close": abs(r0["train_loss"] - refs["train_loss"])
        <= GRAD_LOSS_TOL,
        "train_grads_close": r0["train_grad_rel_l2_max"] <= GRAD_REL_L2,
        "train_every_leaf_has_a_gradient":
            not r0["train_leaves_without_gradient"],
        "train_launches_equal_one_device": all(
            r["train_launches"] == refs["train_launches"] for r in train),
        "train_losses_finite": all(np.isfinite(r["losses"]).all()
                                   for r in train),
        "moe_forward_C=T_close": all(r["moe_C=T_rel_l2"] <= MESH_REL_TOL
                                     for r in moe),
        "moe_forward_own_98pct": all(r["moe_own_close"] > MESH_CLOSE_FRAC
                                     for r in moe),
        "moe_loss_close": abs(m0["moe_loss"] - refs["moe_loss"])
        <= GRAD_LOSS_TOL,
        "moe_grads_close": m0["moe_grad_rel_l2_max"] <= GRAD_REL_L2,
        "moe_launches_equal_one_device": all(
            r["moe_launches"] == refs["moe_launches"] for r in moe),
        "decode_close": all(r["decode_rel_l2_max"] <= MESH_REL_TOL
                            for r in moe),
        "decode_cache_split": m0["decode_seq_shards"] == MESH_MOE_SHAPE[1],
        "ckpt_saved_from_shards": r0["ckpt_files_unequal_to_shards"] == 0,
        "ckpt_restored_onto_elastic_mesh": (not s0["restored_unequal"]
                                            and s0["restored_leaves"] > 0),
    }
    sp = {}
    for name, recs, arch, shape, layers, B in (
            ("qwen3", train, MESH_ARCH, MESH_TRAIN_SHAPE, MESH_SP_LAYERS,
             MESH_B),
            ("moe", moe, MESH_MOE, MESH_MOE_SHAPE, MESH_MOE_LAYERS,
             MESH_MOE_B)):
        first = recs[0]
        gates.update({
            f"sp_{name}_loss_close": abs(first[f"{name}_sp_loss"]
                                         - first[f"{name}_default_loss"])
            <= GRAD_LOSS_TOL,
            f"sp_{name}_grads_close":
                first[f"{name}_sp_grad_rel_l2_max"] <= GRAD_REL_L2,
            f"sp_{name}_every_leaf_has_a_gradient":
                not first[f"{name}_sp_leaves_without_gradient"],
            f"sp_{name}_launches_equal_default": all(
                r[f"{name}_sp_launches"] == r[f"{name}_default_launches"]
                for r in recs),
            f"sp_{name}_no_forward_all_reduce": all(
                "all_reduce" not in r[f"{name}_sp_forward_collectives"]
                for r in recs)})
        sp[name] = {
            "arch": arch, "layers": layers, "mesh": shape, "B": B,
            "S": MESH_S,
            **{f"{k}_{tag}": first[f"{name}_{tag}_{k}"]
               for tag in ("default", "sp") for k in ("loss", "launches")},
            "grad_rel_l2_max": first[f"{name}_sp_grad_rel_l2_max"],
            "grad_rel_l2_worst_leaf":
                first[f"{name}_sp_grad_rel_l2_worst_leaf"],
            **{f"{k}_per_rank_{tag}": [r[f"{name}_{tag}_{k}"] for r in recs]
               for tag in ("default", "sp") for k in ("peak_gb", "grad_s")},
            "pair_s_per_rank": [r[f"{name}_sp_pair_s"] for r in recs],
            **{f"collectives_rank0_{tag}": first[f"{name}_{tag}_collectives"]
               for tag in ("default", "sp")},
            **{f"forward_collectives_rank0_{tag}":
               first[f"{name}_{tag}_forward_collectives"]
               for tag in ("default", "sp")}}
        if name == "qwen3":
            for tag in ("default", "sp"):
                live = first[f"qwen3_{tag}_collectives"]
                gates[f"sp_qwen3_collectives_equal_dry_run_{tag}"] = (
                    _tally_counts(live) == _tally_counts(dry[tag]))
                sp[name][f"collectives_vs_dry_run_{tag}"] = \
                    _mesh_tally_reading(live, dry[tag])
    ucfg = _mesh_family_config(
        MESH_UNEVEN, next(f for f in MESH_FAMILIES if f[0] == MESH_UNEVEN)[1])
    gates.update({
        "uneven_heads_do_not_divide": ucfg.n_heads % MESH_MOE_SHAPE[1] != 0,
        "uneven_loss_close": abs(m0["uneven_loss"]
                                 - refs[f"{MESH_UNEVEN}_loss"])
        <= GRAD_LOSS_TOL,
        "uneven_grads_close": m0["uneven_grad_rel_l2_max"] <= GRAD_REL_L2,
        "uneven_every_leaf_has_a_gradient":
            not m0["uneven_leaves_without_gradient"],
        "uneven_launches_equal_per_rank": all(
            r["uneven_launches"] == m0["uneven_launches"] for r in moe),
        "uneven_launches_equal_one_device": all(
            r["uneven_launches"] == refs[f"{MESH_UNEVEN}_launches"]
            for r in moe),
        "uneven_collectives_equal_dry_run": (
            _tally_counts(m0["uneven_collectives"])
            == _tally_counts(dry["uneven"]))})
    uneven = {
        "arch": MESH_UNEVEN, "mesh": MESH_MOE_SHAPE,
        "heads": ucfg.n_heads,
        "heads_per_rank": [len(spmd.rank_heads(ucfg.n_heads,
                                               MESH_MOE_SHAPE[1], r))
                           for r in range(MESH_MOE_SHAPE[1])],
        "loss_one_device": refs[f"{MESH_UNEVEN}_loss"],
        "loss_mesh": m0["uneven_loss"],
        "grad_rel_l2_max": m0["uneven_grad_rel_l2_max"],
        "grad_rel_l2_worst_leaf": m0["uneven_grad_rel_l2_worst_leaf"],
        "launches_one_device": refs[f"{MESH_UNEVEN}_launches"],
        "launches_per_rank": [r["uneven_launches"] for r in moe],
        "grad_s_per_rank": [r["uneven_grad_s"] for r in moe],
        "peak_gb_per_rank": [r["uneven_peak_gb"] for r in moe],
        "collectives_vs_dry_run": _mesh_tally_reading(
            m0["uneven_collectives"], dry["uneven"])}
    families = {}
    for arch, layers, B, S in MESH_FAMILIES:
        cfg = _mesh_family_config(arch, layers)
        gates.update({
            f"{arch}_train_loss_close":
                abs(r0[f"{arch}_loss"] - refs[f"{arch}_loss"])
                <= GRAD_LOSS_TOL,
            f"{arch}_train_grads_close":
                r0[f"{arch}_grad_rel_l2_max"] <= GRAD_REL_L2,
            f"{arch}_train_every_leaf_has_a_gradient":
                not r0[f"{arch}_leaves_without_gradient"],
            f"{arch}_train_launches_equal_one_device": all(
                r[f"{arch}_launches"] == refs[f"{arch}_launches"]
                for r in train),
            f"{arch}_train_losses_finite": all(
                np.isfinite(r[f"{arch}_losses"]).all() for r in train),
            f"{arch}_decode_close": all(
                max(r[f"{arch}_decode_rel_l2"]) <= MESH_REL_TOL
                for r in moe),
            f"{arch}_decode_cache_split_as_cache_specs": all(
                r[f"{arch}_cache_leaves"] > 0
                and not r[f"{arch}_cache_leaves_misplaced"] for r in moe)})
        if "local_attn" in cfg.layer_kinds:
            gates[f"{arch}_decode_ring_wrapped"] = S > cfg.local_window
        families[arch] = {
            "layers": cfg.n_layers, "n_encoder_layers":
                cfg.n_encoder_layers, "B": B, "S": S,
            "train_mesh": MESH_TRAIN_SHAPE, "decode_mesh": MESH_MOE_SHAPE,
            "loss_one_device": refs[f"{arch}_loss"],
            "loss_mesh": r0[f"{arch}_loss"],
            "grad_rel_l2_max": r0[f"{arch}_grad_rel_l2_max"],
            "grad_rel_l2_worst_leaf": r0[f"{arch}_grad_rel_l2_worst_leaf"],
            "launches_one_device": refs[f"{arch}_launches"],
            "launches_per_rank": [r[f"{arch}_launches"] for r in train],
            "grad_s_one_device": refs[f"{arch}_grad_s"],
            "peak_gb_one_device": refs[f"{arch}_peak_gb"],
            "step_ms_per_rank": [r[f"{arch}_step_ms"] for r in train],
            "losses": r0[f"{arch}_losses"],
            "peak_gb_per_rank": [r[f"{arch}_peak_gb"] for r in train],
            "collectives_rank0": r0[f"{arch}_collectives"],
            "decode_steps": MESH_FAMILY_DECODE_STEPS,
            "decode_seq_shards": m0[f"{arch}_seq_shards"],
            "decode_rel_l2_max": max(max(r[f"{arch}_decode_rel_l2"])
                                     for r in moe),
            "decode_rel_l2_rank0": m0[f"{arch}_decode_rel_l2"],
            "decode_step_ms_rank0": m0[f"{arch}_decode_step_ms"],
            "decode_peak_gb_per_rank": [r[f"{arch}_decode_peak_gb"]
                                        for r in moe],
            "cache_leaves": m0[f"{arch}_cache_leaves"]}
    peaks = [r["peak_gb"] for r in train + moe + restore]
    rec = {"phase": "mesh", "nvidia_smi": nvidia_smi_line(),
           "plan": plans,
           "transport": {job: (
               "nccl, a card a rank" if p["backend"] == "nccl" else
               "gloo, every rank on cuda:0 (staged through pinned host "
               "memory)") for job, p in plans.items()},
           "device_per_rank": {job: [r["device"] for r in recs]
                               for job, recs in (("train", train),
                                                 ("moe_decode", moe),
                                                 ("restore", restore))},
           "train": {"arch": MESH_ARCH, "mesh": MESH_TRAIN_SHAPE,
                     "B": MESH_B, "S": MESH_S,
                     "loss_one_device": refs["train_loss"],
                     "loss_mesh": r0["train_loss"],
                     "grad_rel_l2_max": r0["train_grad_rel_l2_max"],
                     "grad_rel_l2_worst_leaf":
                         r0["train_grad_rel_l2_worst_leaf"],
                     "launches_one_device": refs["train_launches"],
                     "launches_per_rank": [r["train_launches"]
                                           for r in train],
                     "grad_s_one_device": refs["train_grad_s"],
                     "grad_s_per_rank": [r["train_grad_s"] for r in train],
                     "step_ms_per_rank": [r["step_ms"] for r in train],
                     "losses": r0["losses"],
                     "peak_gb_per_rank": [r["peak_gb_train"]
                                          for r in train],
                     "collectives_rank0": r0["collectives"],
                     "spawn_s": r0["spawn_s"]},
           "moe": {"arch": MESH_MOE, "layers": MESH_MOE_LAYERS,
                   "mesh": MESH_MOE_SHAPE, "B": MESH_MOE_B, "S": MESH_S,
                   **{k: m0[k] for k in m0 if k.startswith("moe_")},
                   "close_per_rank": [r["moe_own_close"] for r in moe],
                   "loss_one_device": refs["moe_loss"],
                   "launches_one_device": refs["moe_launches"]},
           "decode": {"arch": MESH_ARCH, "mesh": MESH_MOE_SHAPE,
                      "B": MESH_B, "prompt": MESH_S,
                      "steps": MESH_DECODE_STEPS,
                      "seq_shards": m0["decode_seq_shards"],
                      "prefill_max_abs_err": m0["prefill_max_abs_err"],
                      "max_abs_err": max(r["decode_max_abs_err"]
                                         for r in moe),
                      "rel_l2_max": max(r["decode_rel_l2_max"] for r in moe),
                      "argmax_equal_min": m0["decode_argmax_equal_min"],
                      "outside_allclose_max":
                          m0["decode_outside_allclose_max"],
                      "step_ms_rank0": m0["decode_step_ms"],
                      "spawn_s": m0["spawn_s"]},
           "checkpoint": {"saved_on": MESH_TRAIN_SHAPE,
                          "restored_on": list(shape),
                          "layers": MESH_CKPT_LAYERS,
                          "leaves": s0["restored_leaves"],
                          "spawn_s": s0["spawn_s"]},
           "families": families,
           "uneven": uneven,
           "sp": sp,
           "peak_gb_per_rank": peaks,
           "peak_gb_sum_train": sum(r["peak_gb"] for r in train),
           "peak_gb_sum_moe_decode": sum(r["peak_gb"] for r in moe),
           "seconds": time.perf_counter() - t0, "gates": gates}
    emit(rec)
    bad = [k for k, ok in gates.items() if not ok]
    if bad:
        fail(f"mesh: gates failed: {bad}")
    launches = _mesh_sum_launches(train, "train_launches")
    for recs, key in ((moe, "moe_launches"), (moe, "uneven_launches"),
                      *((train, f"{a[0]}_launches") for a in MESH_FAMILIES),
                      *((recs, f"{name}_{tag}_launches")
                        for name, recs in (("qwen3", train), ("moe", moe))
                        for tag in ("default", "sp"))):
        for k, n in _mesh_sum_launches(recs, key).items():
            launches[k] = launches.get(k, 0) + n
    return launches


def summary_line(kernel_results, launches, by_phase):
    """One entry for each kernel whose checks and path both ran, its
    launches summed over the phases that ran it (``launches_by_phase``:
    the paper path's and each main-path phase's)."""
    ref = "src/repro/kernels/"
    sources = {"paged_attention": ("paged_attention.cu",
                                   ref + "paged_attention/kernel.py:89",
                                   "B8_T5"),
               "flash_attention": ("flash_attention.cu",
                                   ref + "flash_attention/kernel.py:69",
                                   "chunk_B8_C32"),
               "flash_attention_bwd": (
                   "flash_attention_bwd.cu",
                   "the autodiff of src/repro/models/components.py:204",
                   "qwen3_B8_S256"),
               "gemm_dataflow": ("gemm_dataflow.cu",
                                 ref + "gemm_dataflow/kernel.py:79",
                                 "scout_expert_bf16"),
               "block_sparse": ("block_sparse.cu",
                                ref + "block_sparse/kernel.py:44",
                                "keep_0.36"),
               "lut_activation": ("lut_activation.cu",
                                  ref + "lut_activation/kernel.py:38",
                                  "silu_f32")}
    out = []
    for name, (src, replaces, case) in sources.items():
        if name not in kernel_results or name not in launches:
            continue
        recs = kernel_results[name]
        main = next(r for r in recs if r["case"] == case)
        out.append({"name": name, "route": "cuda",
                    "source": f"src/repro_torch/csrc/{src}",
                    "replaces": replaces,
                    "launches": launches[name],
                    "max_abs_err": max(r["max_abs_err"] for r in recs),
                    "ms": main["ms"], "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"],
                    "library_ms": main["library_ms"], "case": case,
                    "launches_by_phase": by_phase.get(name, {})})
        if name == "gemm_dataflow":
            out[-1].update(
                launches_f32=launches.get("gemm_dataflow_f32", 0),
                launches_f32_by_phase=by_phase.get("gemm_dataflow_f32", {}))
    emit({"kernels": out})


def main(phases=("env", "kernels", "paper", "serve", "parity",
                 "profile", "fleet", "archs", "tp", "families", "train",
                 "train_families", "dryrun", "mesh"), cards: int = 1) -> int:
    """Run ``phases`` on the first ``cards`` visible cards (one by
    default; with four, the kernels run on every card and the mesh's
    ranks and the tp shards take a card each over NCCL)."""
    # the first ``cards`` visible cards (before torch sees the devices)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = visible.split(",") if visible else [str(i) for i in range(cards)]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:cards])
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs "
              "one GPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cards:
        print(f"chip_smoke: {cards} cards asked for, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results, launches, by_phase = {}, {}, {}

    def count(new, phase):
        for k, n in new.items():
            launches[k] = launches.get(k, 0) + n
            by_phase.setdefault(k, {})[phase] = n
    if "env" in phases:
        phase_env()
    if "kernels" in phases:
        results.update(phase_kernels())
    if "paper" in phases:
        paper_results, paper_launches = phase_paper()
        results.update(paper_results)
        count(paper_launches, "paper")
    if "serve" in phases:
        model, params, programs, done, served, graphs = phase_serve()
        count(served, "serve")
        if "parity" in phases:
            phase_parity(model, params, done)
        if "profile" in phases:
            graphs["profile"] = phase_profile(model, params, programs)
        if "fleet" in phases:
            count(phase_fleet(model, params, programs), "fleet")
        # the bundle's graphs over every engine of these phases
        emit({"phase": "graphs", **graphs,
              "bundle": programs.graph_stats.as_dict(),
              "card": nvidia_smi_line()})
        # the later phases' models need the card's memory
        del model, params, programs, done
        gc.collect()
        torch.cuda.empty_cache()
    if "archs" in phases:
        count(phase_archs(), "archs")
    if "tp" in phases:
        count(phase_tp(), "tp")
    # the dryrun phase's production cells trace on the CPU meanwhile
    dry_cells = _dry_cells_start() if "dryrun" in phases else None
    if "families" in phases:
        count(phase_families(), "families")
    if "train" in phases:
        count(phase_train(), "train")
    if "train_families" in phases:
        count(phase_train_families(), "train_families")
    if "dryrun" in phases:
        phase_dryrun(dry_cells)
    if "mesh" in phases:
        count(phase_mesh(), "mesh")
    if results:
        summary_line(results, launches, by_phase)
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
