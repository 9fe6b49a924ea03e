"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card: name and power limit (nvidia-smi); TF32 off for matmul and cuDNN
  2. build: the five kernels (the fused CowClip + coupled-L2 + Adam
     update, the sparse pair, the chunked WKV6 scan and the embedding
     backward) for sm_90a into one extension, from the sources under
     src/repro_torch/kernels
  3. fused kernel vs its plain PyTorch version at [10131227, 10],
     [10131227, 1] and [4, 10], and at the redesign's edges: V = 100003
     (no multiple of the rows a warp's tile covers) with D in {1, 2, 3,
     10, 16, 17, 64}, all rows absent and all touched; steps 1 and 1000,
     rtol 1e-5 / atol 1e-7
  4. train: DeepFM at deepfm-criteo width (26 fields, 33.76M ids, emb 10,
     MLP 3x400, 13 dense) on synthetic Zipf data, batch 131072 (base 1024),
     4 steps of the fused placement plus one eval through train_ctr; the
     kernel must launch exactly 52 times per step, the embedding backward
     run once (the fm and the LR lookup in one call, after one sort), and
     the loss stay finite; ms/step from train_ctr's CUDA events
  5. trace: 2 more fused steps through train_ctr under torch.profiler,
     device time by kernel, the fused update's kernels a step, and every
     host read of a scalar (aten::_local_scalar_dense) per step, whether
     it copies from the card, with the ops and port source that made it:
     none may copy from the card, and none of PyTorch's embedding backward
     kernels may run; a known device read is first seen as one
  6. agreement: 3 fused steps at a small size on the card against the same
     steps on the CPU (the path the CPU tests hold to the JAX package)
  7. fused kernel time on the largest table with CUDA events (L2 flushed
     before each launch; the wrapper's host work covered, and also not),
     beside its bound and the plain version's time: [10131227, 10] with
     one batch's counts and half touched, and [10131227, 1] (the 26 LR
     tables' D) with one batch's counts
  8. sparse kernels vs their plain versions: [10131227, 10] and
     [10131227, 1] at capacity 131072 (one Zipf batch of the largest field's
     unique ids plus pads), pending depths 0-1000, steps 1 and 1000; a
     [4, 10] case; a row_offset case against the last of 4 row shards of
     the largest table; the grouped launch over the 52 tables of phase 9's
     first batch (steps 1 and 1000, depths 0-1000): real slot rows and
     tables at rtol 1e-5 / atol 1e-7, last_step equal, untouched rows
     bitwise unchanged, the depth equal to the per-table formula
  9. sparse train: the same model, data and hypers through the sparse
     placement, 4 steps, flush and one eval through train_ctr; each sparse
     kernel must launch exactly once per step over all 52 tables, the
     single-table wrappers and the fused kernel never, the embedding
     backward once a step (into the fm and the LR slot rows in one call,
     in the dedups' order: no sort of its own)
 10. sparse trace: 2 more sparse steps, as phase 5, with the sparse pair's
     device time a step
 11. sparse agreement at phase 6's small size: 3 sparse steps on the card
     against the CPU path, the same steps twice on the card bitwise equal,
     and flushed sparse against fused on the card
 12. sparse kernel times at [10131227, 10] and [10131227, 1], and over one
     step's 52 tables (one grouped launch each, and the same kernels a
     launch a table), with CUDA events (L2 flushed before each launch;
     host work covered, and also not), beside their byte bounds (summed
     over the tables from the batch's real counts) and the plain versions'
     times
 13. wkv6 kernel vs its plain versions (the chunked one and the exact
     recurrence) at the JAX sweep, chunks 4 / 8 / 16, exact zeros in w,
     [256, 4096, 64] and [64, 32768, 64]; at the redesign's edges (one
     chunk, BH = 1, N in {8, 16, 32, 64}, chunks 4 / 8 / 16, zeros,
     segments that do not divide the chunks) also vs the segmented plain
     version; a ragged S raises ValueError
 14. serve: rwkv6-7b at full width (7,534,546,944 params, bf16 compute,
     chunked backend), score-only prefill of 4 x 4096, 1 x 32768 and a
     ragged 1 x 4001 tokens; 32 wkv6 launches per forward, logits finite
 15. greedy generation: 4 x 64-token prompts, 32 new tokens (32 wkv6
     launches per cached prefill, none in decode); the kernel on layer 0's
     real streams against the exact recurrence
 16. trace: a full-width prefill and a decode step under torch.profiler;
     the wkv6 kernels summed as the scan's share of the prefill
 17. agreement at the reduced f32 size, card vs CPU, at 64 and at a
     ragged 61 tokens: forward logits, cached prefill, 4 decode steps
 18. wkv6 kernel times with CUDA events (L2 flushed before each launch),
     beside its bound and the plain version's time
 19. scan engine, fused: 8 steps of the fused placement at phase 4's width
     and batch through train_ctr's eager engine, again, and through its
     scan engine (4 steps a captured CUDA graph), from the same params
     over the same batches, under PyTorch's default algorithms: one
     step's gradients computed twice, then params, moments, counters and
     losses of the three runs, all bitwise equal, the embedding backward
     run once a step (its sorts counted: one a step); one replay traced:
     52 fused-update launches a step, the embedding backward's 4 level
     launches a step, none of PyTorch's embedding backward, no host read
     of a scalar, the idle share; the steady ms/step over 25 chunks each
     way
 20. scan engine, sparse: as 19 through the sparse placement; one launch
     of each sparse kernel a step, the fused kernel and the single-table
     wrappers none, and no sort for the embedding backward
 21. guard: at phase 6's small size, a chunk of 4 batches whose second
     holds a NaN under nonfinite_guard, both placements: the poisoned
     step leaves params, moments, last_step and step bitwise unchanged,
     the graph's replay equals the eager steps, skipped_steps sum to 1
 22. serving: a ServingEngine over phase 19's fused snapshot at full
     width, batch_size 8192 (one captured graph): requests of 1, 100,
     8192 and 20,000 rows against the eager forward (1e-5); a
     MicroBatcher behind 8 client threads answers every request once; a
     HotEmbeddingCache equals the engine (1e-5); rows/s, p50 / p99 ms
 23. decode graph (beside phase 15): the decode step captured once for
     batch 4 (a recurrent state: one graph at any max_len); 4 x 64-token prompts, 32 new tokens: the eager tokens,
     logits within 1e-4; ms per decoded token eager and graph, and a
     traced replay beside phase 16's eager step
 24. embedding backward vs its plain version, bitwise (and the max abs
     error printed): one Zipf batch's 26 fields at 131,072 rows, the fm
     (D = 10) and LR (D = 1) groups in one call, run twice (bitwise) and
     against a single call a group (bitwise); 3 groups (10, 1, 16); D =
     17, 64; a field of one id; ids past their tables; the sparse step's
     slot rows in the dedups' plan (equal to the stable sort of the slot
     keys) and under overflow; the step's one call (sort, fill, levels)
     timed beside the combined byte bound, the parent's form (a call a
     lookup), the call on a plan (no sort), the sort and the fill alone,
     the plain version and PyTorch's embedding_dense_backward on the
     same inputs
 25. substrate: the composable optimizer chain at phase 19's width,
     params and batches: in lockstep with the fused placement, every
     param within rtol 1e-5 / atol 1e-8 after the first step and the
     untouched embedding rows bitwise after each of 4 (the later steps'
     gaps printed); 4 steps eager (the embedding backward once a step,
     one sort) and through the scan engine: bitwise equal; a traced replay
     (0 host reads, the embedding backward's 4 level launches a step);
     steady ms/step over 10
     chunks each way; metrics.auc on the card against auc_numpy on its
     eval (1e-6)
 26. Table-7 clips: the substrate with each of the six clip kinds at
     phase 6's small size, 3 steps on the card against the CPU
 27. hot/cold, sync: 8 online steps of train_ctr(mode="stream") at phase
     19's width, batch and initial params, capacity 4096 a field,
     cumulative admission, over a synthetic event stream: eager, eager
     again and the scan engine (4 steps a graph) bitwise equal (params,
     moments, last_step, hot tier, slot maps, frequencies, losses); one
     launch of each grouped sparse kernel and one embedding backward run
     (no sort) a step, nothing of the fused kernel or the single-table
     wrappers; flushed, against the sparse placement over the same
     batches (max abs <= 1e-7); a traced replay (its kernels, device time
     by kind, 0 host reads, no PyTorch embedding backward, the idle
     share); hit rate, evictions and catch-up depth a step, the hot tier's
     and residency maps' bytes, peak memory, ms/step of both engines
 28. hot/cold capacities 4096 and 65536 over phase 27's batches: flushed
     params bitwise equal, the hit rate no lower at 65536
 29. the async mem cold store at capacity 4096 over phase 27's batches
     (the planner on the stream's worker, chunks of 1): exported params
     bitwise equal to phase 27's; plan and stall seconds a step, the
     overlap fraction, bytes copied to and from the card a step, ms a
     step; one more plan under cProfile; one dispatch traced on the
     consumer's thread, 0 host reads
 30. at phase 6's small size (capacity 64): the sync hot/cold step over
     3 steps, both admission policies, against the sparse placement on
     the card and on the CPU (max abs <= 1e-7) and card against CPU (rtol
     1e-5 / atol 1e-5, phase 11's bar, beside the sparse placement's own
     card-vs-CPU gap; resident ids and frequencies equal); the async mmap
     store flushed, closed, reopened and run on, bitwise equal to an
     uninterrupted run
 31. durability at deepfm-criteo width: the sync hot/cold step at
     capacity 4096, the scan engine with 4 steps a graph, under the
     non-finite guard: guarded against unguarded over 8 clean steps,
     bitwise; a NaN batch inside a replayed chunk against the eager
     guarded steps (the poisoned step leaves every leaf bitwise
     unchanged; skipped_steps 1; one launch of each sparse kernel and one
     embedding backward a step, as unguarded); a traced guarded replay (0
     host reads); the guard's ms a graph step beside the unguarded one,
     in turns; snapshots every 4 steps (each one's seconds: flush, export
     to the host, write with fsync, sha256, manifest with rename and
     rotation; its bytes), the stream's ms a step with and without them,
     the resume's seconds, and the run resumed from step 4 against the
     uninterrupted one with the same cadence, bitwise
 32. durability at phase 6's small size: the sparse placement stopped
     at pending decay depth 2 and resumed; the async mem and mmap stores
     snapshotted and resumed in a fresh bundle; a fused snapshot resumed
     under sparse (params only, warned); the CLI killed by a FaultPlan in
     a child process inside its step-8 snapshot write, then --resume:
     each bitwise equal to its uninterrupted run
 33. sharded (div) on an NCCL world of one rank (a 1x1 grid: every
     collective issued at size 1), at phase 19's width, batch and initial
     params: 4 steps eager (52 fused-update launches and one embedding
     backward run, with its sort, a step) and through the scan engine (4
     steps a graph, the NCCL calls captured), bitwise equal; one step
     against the substrate at phase 25's bar (rtol 1e-5 / atol 1e-8) and,
     printed, against fused; a traced replay (52 fused launches a step,
     the embedding backward's level launches, NCCL's kernels with their
     device time, 0 host reads); the collectives of 2 eager steps (6 a
     step) and their host time; steady ms/step over 10 chunks each way;
     the process group destroyed at the end
 34. sharded_sparse (div), as 33: one launch of each sparse kernel a
     step, no fused launch, overflow_shards 0; one step against the
     flushed sparse placement at the same bar; the forward's inline decay
     against the catch-up kernel's rows, bitwise (after the run, and at
     pending depths to 1000); 7 collectives a step; at phase 6's small
     size a capped capacity (64) that overflows, eager and in a replayed
     chunk (bitwise, the same count), against the substrate on the card
     (rtol / atol 1e-5)
 35. the guard on sharded and sharded_sparse (div) on an NCCL world of one
     rank, at phase 19's width, batch, initial params and batches, 4 steps
     a graph: guarded against unguarded over 8 clean steps through the
     scan engine, bitwise; a chunk whose 2nd batch holds a NaN: the eager
     guarded steps skip it (every leaf bitwise unchanged by it; kernel 1
     52 launches a step on sharded, kernels 2 and 3 one each on
     sharded_sparse, the embedding backward one run with one sort, as
     unguarded) and the chunk's replay equals them, skipped_steps 1; a
     traced guarded replay (0 host reads); the guard's ms a graph step
     against unguarded, 10 replays each way in turns
 36. streaming with snapshots on the sharded placements (an NCCL world of
     one rank): sharded_sparse (div) at full width through
     train_ctr(mode="stream"), 12 online steps, 4 a graph, a snapshot at
     step 8 (its bytes and seconds by part: flush, export with the
     state's gather and the host copy, write with fsync, sha256, manifest
     with rename), resumed from it in a fresh bundle for the last 4 steps
     (its seconds): bitwise equal to the uninterrupted run; the online ms
     a step; sharded (div) the same way at phase 6's small size; the CLI
     (--placement sharded_sparse --mode stream) killed in a child process
     by a FaultPlan inside its step-8 snapshot write, then --resume:
     bitwise equal to its uninterrupted run
 37. gemma3-12b at full width and depth (12,772,028,160 params drawn on
     the card after rwkv6-7b's are freed; 40 local layers with a
     1024-slot ring cache, 8 attn layers with a linear one), f32 compute:
     a cached prefill of 2 x 1000 tokens then 64 teacher-forced decode
     steps (the ring wraps at 1024), and 2 x 1536 + 16 (the prefill's
     roll), held to one forward over all the tokens within 5e-3 (the JAX
     package's decode-vs-forward bar)
 38. the same params in bf16: score-only prefill of 1 x 4096 (ms,
     tokens/s); greedy generation of 4 x 1000-token prompts + 64 tokens
     eager and from the decode graph (its cursor on the card), the same
     tokens and logits within 1e-4 (bitwise or not, printed), ms per
     decoded token each way, the KV caches' bytes; no port kernel
     launched in 37-38; peak device memory a phase
 39. the six attention archs (and deepseek with pad_attn_heads 8) at the
     reduced f32 size, card vs CPU: forward logits, cached prefill and 4
     decode steps, max abs 1e-4
 40. zamba2-2.7b at full width and depth (2,422,670,240 params drawn on
     the card after gemma3-12b's are freed; 54 Mamba-2 layers, the
     shared attention + MLP block after every 6, a ring of 4096 each),
     f32: a cached prefill of 2 x 1000 tokens then 64 teacher-forced
     decode steps held to one forward over the 1064 tokens within 5e-3;
     forward, prefill and decode-step times; the kernel launches of the
     prefill as the profiler counts them
 41. the same params in bf16: score-only prefill of 1 x 4096 (ms,
     tokens/s, a traced run's idle share); greedy generation of 4 x
     1000-token prompts + 64 tokens eager and from the decode graph, as
     phase 38, the decode state's bytes by part (shared rings, SSM
     states, conv tails), a traced replay with no host read of a device
     scalar
 42. granite-moe-3b-a800m at full width (3,425,404,416 params,
     1,009,485,312 active): f32 at capacity factor 5.0 (no drop), 2 x
     1000 + 64 decode vs forward within 5e-3; the share of token-slots
     the config's 1.25 drops in that forward; bf16 at 1.25 as phase 41,
     the replay's device time by group with the expert einsums' kernels
 43. zamba2-2.7b (a 12-token prompt past its ring of 8),
     granite-moe-3b-a800m and llama4-scout-17b-a16e at the reduced f32
     size, card vs CPU: forward logits, the MoE aux, cached prefill and
     4 decode steps, max abs 1e-4; no port kernel launched in 40-43
 44. LM training's kernels at rwkv6-7b's shapes: the fused CowClip update
     of the [65536, 4096] token table with one 8 x 512 batch's counts,
     against its plain version at rtol 1e-5 / atol 1e-7 (steps 1 and
     1000), timed beside its bound
 45. the embedding backward of that batch's 4096 token rows of width 4096
     into 65536 rows, bitwise its plain version (and run twice), timed
     beside its bound and PyTorch's embedding_dense_backward
 46. wkv6 under autograd at [512, 512, 64]: the kernel's forward at the
     wkv6 bar against the chunked plain version, its gradients of r, k,
     v, w and u bitwise the plain version's autograd; the kernel, the
     plain forward and the plain backward (the recompute) timed, and the
     backward's memory
 47. a reduced f32 LM step of each family (rwkv6 through the kernels,
     attention, Mamba-2 with the shared block, MoE, a frontend prefix)
     on the card against the CPU from the card's params: loss within
     1e-4, every gradient leaf within 1e-3 of its largest value, params
     within 1e-4 after the CPU's update of the card's gradients
 48. rwkv6-7b at full width, 8 of its 32 layers, bf16, trained 10 steps
     of batch 8 x 512 through make_lm_train_step (the CLI's step): the
     loss at steps 1 and 10 (it must fall), ms a step (CUDA events, the
     median of steps 3-10) and tokens/s, peak memory; a traced step:
     8 wkv6, 1 fused CowClip and 1 embedding backward launches, no host
     read of a device scalar, no PyTorch embedding backward, the idle
     share; a second run of 3 steps from the same seed bitwise the first
Phase 24 runs after 12; phases 19-22 and 25-36 between 24 and 13;
phases 37-43, then 44-48, last. Each
phase starts with a flushed "[phase N] start" line, and faulthandler
prints every thread's Python stack if the process dies of a signal.
The last two lines are the kernels' JSON summary and the result line.
Exits non-zero, printing no result, without a CUDA device or without the
repository's src/ beside this file.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
RTOL, ATOL = 1e-5, 1e-7        # the JAX kernel's own bar (tests/test_kernels.py)
TRAIN_STEPS = 4
BATCH = 131072
BASE_BATCH = 1024
L2_FLUSH_BYTES = 256 * 2**20   # > the H100's 50 MB L2
HOST_COVER_CYCLES = 2_000_000  # ~1 ms of the card's clock: > a wrapper's
                               # host work before its launch
STEP_COVER_CYCLES = 40_000_000  # ~20 ms: > the host work of 52 wrapper
                                # calls, or of one over 52 tables
# the fused update's kernels (one a launch, by D and alignment) and the
# scan's (the segment pass and the carry only when BH is short of the SMs)
FUSED_KERNELS = ("cowclip_adam_tile_kernel", "cowclip_adam_kernel")
WKV6_KERNELS = ("wkv6_segment_state_kernel", "wkv6_segment_carry_kernel",
                "wkv6_chunked_kernel")
SPARSE_KERNELS = ("sparse_catchup_kernel", "sparse_update_kernel")
EMBED_KERNELS = ("embedding_backward_level_kernel",)
EMBED_GROUP = ("the embedding backward's kernels", EMBED_KERNELS)
PORT_KERNELS = FUSED_KERNELS + SPARSE_KERNELS + WKV6_KERNELS + EMBED_KERNELS
# PyTorch's CUDA embedding_dense_backward (EmbeddingBackwardKernel.cu,
# Embedding.cu): none of its kernels may run in a traced step of the port
TORCH_EMBED_BACKWARD = ("embedding_backward_feature_kernel",
                        "compute_grad_weight", "sum_and_scatter",
                        "krn_partials_per_segment",
                        "krn_partial_segment_offset")
WKV_Y_REL = 1e-4               # the JAX wkv6 test's bar: max |dy| / max |y|
WKV_S_RTOL, WKV_S_ATOL = 1e-3, 1e-4   # ... and its bar on the final state
WKV_FULL = (256, 4096, 64)     # batch 4 x 64 heads, 4096 tokens, head 64
WKV_LONG = (64, 32768, 64)     # batch 1 x 64 heads, 32768 tokens
RWKV6_7B_PARAMS = 7_534_546_944   # repro.models.lm.param_counts(rwkv6-7b)
LM_PREFILL = (4, 4096)         # requests x tokens, score-only prefill
LM_LONG = (1, 32768)           # prefill_32k's length, at batch 1 (not 32)
LM_RAGGED = (1, 4001)          # a prompt length that is no multiple of 16
LM_REPEATS = 2
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 64, 32
GEMMA3_12B_PARAMS = 12_772_028_160   # repro.models.lm.param_counts(gemma3-12b)
ATTN_TEACHER = ((1000, 64), (1536, 16))   # f32 prompt + fed tokens, 37
ATTN_DECODE_BAR = 5e-3         # decode vs forward (tests/test_lm_smoke.py)
ATTN_PREFILL = (1, 4096)       # score-only bf16 prefill, 38, 41 and 42
ATTN_GEN_BATCH, ATTN_GEN_PROMPT, ATTN_GEN_NEW = 4, 1000, 64   # 38, 41, 42
# kernel-name groups of the attention LM's traces (phase 38): PyTorch's
# casts (the f32 weights to bf16) and copies, cuBLAS's GEMMs, the softmax
ATTN_GROUPS = (("casts and copies", ("bfloat16_copy_kernel",
                                     "direct_copy_kernel")),
               ("GEMMs", ("gemm", "xmma", "nvjet", "cutlass")),
               ("softmax", ("SoftMax", "softmax")))
ZAMBA2_PARAMS = 2_422_670_240   # repro.models.lm.param_counts(zamba2-2.7b)
GRANITE_MOE_PARAMS = (3_425_404_416, 1_009_485_312)   # its total, active
HYBRID_TEACHER = (1000, 64)    # f32 prompt + fed tokens, phases 40 and 42
MOE_NO_DROP = 5.0              # the capacity factor whose capacity is a
                               # group's 1064 tokens: phase 42 drops none
# the MoE dispatch's stable sorts, beside the attention groups (41-42)
HYBRID_GROUPS = ATTN_GROUPS + (("sorts", ("sort", "Sort", "radix")),)
HYBRID_ARCHS = ("zamba2-2.7b", "granite-moe-3b-a800m",
                "llama4-scout-17b-a16e")
ATTN_ARCHS = ("stablelm-3b", "granite-20b", "deepseek-coder-33b",
              "gemma3-12b", "musicgen-large", "internvl2-26b")
LM_AGREE = 1e-4                # max abs logits, card vs CPU (f32, reduced)
# LM training (phases 44-48): rwkv6-7b at full width, its 32 layers cut
# to 8, batch 8 x 512 tokens (run_lm's base batch of 1024 tokens x 4)
LM_TRAIN_LAYERS = 8
LM_TRAIN_PARAMS = 2_286_292_992   # lm.param_counts(rwkv6-7b at 8 layers)
LM_TRAIN_BATCH = (8, 512)
LM_TRAIN_STEPS = 10
# --base-lr of phase 48's run (embedding lr 2.5e-5, dense lr 1e-4 after
# the warm-up at 4096 tokens a step): at the CLI's default 2e-2 (dense lr
# 8e-2) this width diverges, the loss 11.56 -> 154.4 in 10 steps; from
# 2.5e-4 to 5e-5 it jumps to 14-25 after the first updates
# (scripts/lm_train_lr_sweep.py)
LM_TRAIN_BASE_LR = 2.5e-5
LM_TRAIN_REPEAT = 3            # steps of each of the two runs held bitwise
LM_TRAIN_TABLE = (65536, 4096)  # rwkv6-7b's token table (padded vocab, D)
LM_TRAIN_WKV = (512, 512, 64)   # the mixer's wkv6 call: batch 8 x 64 heads
LM_TRAIN_ARCHS = ("rwkv6-7b", "gemma3-12b", "zamba2-2.7b",
                  "granite-moe-3b-a800m", "musicgen-large")
# a gradient leaf's max abs difference over its own largest |g|, card vs
# CPU (phase 47). rwkv6 has its own bar: its per-head norm of the wkv
# output (eps 1e-5) divides positions whose output is tiny by up to 316,
# so f32 rounding set by the largest outputs comes back magnified in the
# gradients of its r/k path (1.14e-4 card vs CPU; on the CPU the port's
# scan is 1.92e-4 from JAX's, and with eps 0.1 under 2e-5:
# tests/test_torch_lm_train.py)
LM_GRAD_BAR = 1e-4
LM_GRAD_BAR_RWKV6 = 3e-4
LM_AGREE_STEPS = 3             # steps of each family held card vs CPU
# phase 47's run of the CLI on the card: reduced rwkv6-7b, batch 16 x 64
LM_CLI_ARGS = ("--task", "lm", "--arch", "rwkv6-7b", "--reduced", "--batch",
               "16", "--seq", "64", "--steps", "5")
GRAPH_STEPS = 8                # steps of each engine, phases 19-20
SCAN_STEPS = 4                 # steps a captured graph, phases 19-20
TIMED_CHUNKS = 25              # chunks timed each way, steady state, 19-20
SUBSTRATE_STEPS = 4            # steps of each engine, phase 25
SUBSTRATE_CHUNKS = 10          # chunks timed each way, phase 25
SERVE_BATCH = 8192             # the serving engine's one shape, phase 22
SERVE_SIZES = (1, 100, 8192, 20000)   # request rows, phase 22
SERVE_TIMED = 1000             # requests timed one at a time, phase 22
SERVE_FULL_TIMED = 64          # SERVE_BATCH-row requests timed, phase 22
SERVE_CLIENTS, SERVE_REQUESTS = 8, 125  # micro-batcher clients x requests
HOT_CAPACITY = 65536           # hot rows a field on the card, phase 22
HOT_STEPS = 8                  # steps of each hot/cold run, phases 27-29
HOT_CAP = 4096                 # hot rows a field, phases 27 and 29
HOT_CAP_BIG = 65536            # the second capacity, phase 28
HOT_TIMED = 10                 # chunks timed each way, phase 27
HOT_AGREE = 1e-7               # max abs, hotcold vs sparse, phase 30
DUR_STEPS = 8                  # steps of each run, phase 31
SNAP_EVERY = 4                 # steps between snapshots, phase 31
DUR_TIMED = 10                 # replays timed each way (the guard), 31
SHARD_STEPS = 4                # steps of each engine, phases 33-34
SHARD_TIMED = 10               # chunks timed each way, phases 33-34
SHARD_CAP = 64                 # the capped slot capacity at phase 6's
                               # small size, phase 34
GUARD_STEPS = 8                # clean steps guarded and unguarded, phase 35
GUARD_TIMED = 10               # replays timed each way (the guard), 35
STREAM_STEPS = 12              # online steps of each run, phase 36
STREAM_SNAP = 8                # the step of its snapshot, phase 36
# NCCL's kernels (ncclDevKernel_*, ncclKernel_*): the sharded steps'
# collectives on the card
NCCL_GROUP = ("NCCL's kernels", ("nccl",))
# the collectives a step issues at the exact capacity: the lookups' SUM
# over "model" (fm, lin), the loss and tower's SUM over "data", the row
# gradients' SUM over "data" (fm, lin), and the counts' SUM over "data"
# (sharded) or the overflow count's SUM and the depth's MAX over "model"
COLLECTIVES = {"sharded": 6, "sharded_sparse": 7}


# each port kernel's wrapper calls on its main path's run (phase 4 for
# the embedding backward), for the kernels' JSON line
MAIN_PATH_LAUNCHES: dict = {}


def phase_start(n):
    """The flushed line each phase starts with, so a crash names the
    phase it happened in (with faulthandler's stacks on stderr)."""
    print(f"[phase {n}] start", flush=True)
    sys.stderr.flush()


def phase_end():
    """After a phase: every tensor it made that is unreferenced freed
    (captured graphs and their pools with them) and the card idle."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_time_cold_ms(fn, iters, scratch, warmup=1, cover=True,
                      cover_cycles=HOST_COVER_CYCLES):
    """Mean time of ``fn`` with the L2 cache flushed before each launch
    (the main path meets its table rows cold): CUDA events around each
    call alone. The flush reads ``scratch``, so it leaves no dirty lines
    whose write-back would be timed with ``fn``; then, with ``cover``, the
    card spins for ``cover_cycles``, so the wrapper's host work (longer
    than a short kernel) is done before the start event runs and is not
    timed. ``cover=False`` times that host work too (the flush alone)."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        scratch.max()
        if cover:
            torch.cuda._sleep(cover_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def compare(phase, tag, a, b, worst):
    """Hold ``a`` (kernel) to ``b`` (plain version) at rtol/atol, print the
    result (with ``phase`` None, only a failure) and fold the max abs error
    into ``worst[0]``."""
    err = (a - b).abs()
    # share of the allowed error used by the worst element (<= 1 passes);
    # a plain relative error is meaningless where the reference is near 0
    used = (err / (ATOL + RTOL * b.abs())).max().item() if err.numel() \
        else 0.0
    ok = torch.allclose(a, b, rtol=RTOL, atol=ATOL)
    worst[0] = max(worst[0], err.max().item() if err.numel() else 0.0)
    if phase is not None or not ok:
        print(f"[{phase or 'compare'}] {tag}: max_abs "
              f"{err.max().item():.3e}, worst "
              f"|err|/(atol + rtol*|ref|) {used:.3f} (rtol {RTOL}, atol "
              f"{ATOL}) {'ok' if ok else 'FAIL'}")
    check(ok, f"kernel disagrees with its plain version: {tag}")


def slot_set(col, vocab, cap, lo=0):
    """The static-capacity slot set of the ids in ``[lo, vocab)`` of one
    batch column, by the sparse step's own dedup: ``(uids, counts)``."""
    from repro_torch.models.embedding import unique_ids

    u = unique_ids(col[col >= lo], vocab, cap)
    return u.uids, u.counts


def sparse_tables(gen, rows, dim, max_depth):
    w = 0.01 * torch.randn(rows, dim, generator=gen, device="cuda")
    m = 0.01 * torch.randn(rows, dim, generator=gen, device="cuda")
    v = 0.001 * torch.randn(rows, dim, generator=gen, device="cuda").abs()
    ls = torch.randint(0, max_depth + 1, (rows,), generator=gen,
                       device="cuda", dtype=torch.int32)
    return w, m, v, ls


def criteo_data(steps=TRAIN_STEPS, seed=0):
    """The CTR phases' synthetic Zipf data at deepfm-criteo width, enough
    for ``steps`` batches: (train, test)."""
    from repro_torch.configs.deepfm_criteo import CRITEO_VOCABS
    from repro_torch.data import make_ctr_dataset

    n_samples = math.ceil(steps * BATCH / 0.9 / BATCH) * BATCH
    return make_ctr_dataset(n_samples, CRITEO_VOCABS, n_dense=13, zipf_a=1.1,
                            seed=seed).split(0.9)


def criteo_hypers():
    """The CTR phases' hyperparameters: CowClip scaling from base batch
    BASE_BATCH to BATCH."""
    from repro_torch.core.scaling import scale_hyperparams

    return scale_hyperparams("cowclip", base_lr=1e-4, base_l2=1e-5,
                             base_batch=BASE_BATCH, batch_size=BATCH,
                             base_dense_lr=2e-4)


def step_slot_sets(ids, vocabs):
    """One batch's slot set of every field, by the sparse step's own dedup
    (capacity min(batch, vocab)): ``[(uids, counts)]`` in field order."""
    from repro_torch.models.embedding import batch_unique

    uniq = batch_unique(ids, vocabs)
    return [(uniq[f"field_{i}"].uids, uniq[f"field_{i}"].counts)
            for i in range(len(vocabs))]


def step_tables(gen, vocabs, slot_sets, dims, max_depth):
    """The tables of one sparse step, in the step's order (the fm tables,
    then the LR ones): ``(w, m, v, last_step, uids, counts)`` each, with
    pending depths 0 to ``max_depth`` drawn on the card."""
    return [(*sparse_tables(gen, vocab, dim, max_depth), uids, counts)
            for dim in dims for vocab, (uids, counts) in zip(vocabs,
                                                             slot_sets)]


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def catchup_bound(tables):
    """Least time for the catch-up of ``tables`` (``[(counts, dim)]``):
    every slot reads its count and writes 3 rows (a pad's are zeros); a
    real slot also reads its uid, its last_step and 3 table rows. About 2
    f32 operations per real element plus one pow per real slot. Returns
    (ms, by, real slots, bytes)."""
    nbytes = flops = reals = 0
    for counts, dim in tables:
        cap, real = counts.numel(), int((counts > 0).sum())
        nbytes += cap * (4 + 12 * dim) + real * (8 + 12 * dim)
        flops += real * (dim + 20)
        reals += real
    return (*_bound(nbytes, flops), reals, nbytes)


def scatter_bound(tables):
    """Least time for the update of ``tables`` (``[(counts, dim)]``):
    every slot reads its count; a real slot reads its uid and 4 slot rows
    (w, g, m, v) and writes 3 table rows and its last_step. About 25 f32
    operations per real element. Returns (ms, by, real slots, bytes)."""
    nbytes = flops = reals = 0
    for counts, dim in tables:
        cap, real = counts.numel(), int((counts > 0).sum())
        nbytes += cap * 4 + real * (8 + 28 * dim)
        flops += real * dim * 25
        reals += real
    return (*_bound(nbytes, flops), reals, nbytes)


def time_sparse_step(cc, gen, vocabs, slot_sets, dims, scratch, step, *,
                     lr, l2, plain=True, iters=20):
    """One step's catch-up and update over every table (``step_tables``
    of ``slot_sets``, pending depths through step 1000), each timed with
    the L2 flushed before it and the host's work covered
    (STEP_COVER_CYCLES), and with the flush alone; ``cc`` is the wrappers'
    module (``repro_torch.kernels.cowclip``): its grouped wrappers where it
    has them, else its single-table ones, one call a table. ``step`` is
    the step 1000 as ``cc``'s wrappers take it, made before the timed
    launches. With ``plain``, the plain versions' time too, table by
    table. Returns {name: (ms, flush-alone ms, plain ms or None, bound ms,
    bound by, real slots, bytes)}."""
    from repro_torch.kernels.cowclip import ref as cc_ref

    group = step_tables(gen, vocabs, slot_sets, dims, 1000)
    cols = [list(c) for c in zip(*group)]       # w, m, v, ls, uids, counts
    kw = dict(lr=lr, l2=l2)
    upd_kw = dict(kw, r=1.0, zeta=1e-5)
    grouped = hasattr(cc, "sparse_gather_catchup_tables")
    if grouped:
        rows, _ = cc.sparse_gather_catchup_tables(*cols, step, **kw)
    else:
        rows = [cc.sparse_gather_catchup(*t, step, **kw) for t in group]
    grads = [0.1 * torch.randn(r[0].shape, generator=gen, device="cuda")
             for r in rows]

    def catchup():
        if grouped:
            cc.sparse_gather_catchup_tables(*cols, step, **kw)
            return
        for t in group:
            cc.sparse_gather_catchup(*t, step, **kw)

    def update():
        if grouped:
            cc.sparse_update_scatter_tables(
                *cols, [r[0] for r in rows], grads, [r[1] for r in rows],
                [r[2] for r in rows], step, **upd_kw)
            return
        for t, r, g in zip(group, rows, grads):
            cc.sparse_update_scatter(*t, r[0], g, r[1], r[2], step, **upd_kw)

    def plain_catchup():
        for w, m, v, ls, uids, _ in group:
            cc_ref.sparse_gather_catchup_reference(w, m, v, ls, uids, step,
                                                   **kw)

    def plain_update():
        for t, r, g in zip(group, rows, grads):
            cc_ref.sparse_update_scatter_reference(*t, r[0], g, r[1], r[2],
                                                   step, **upd_kw)

    shapes = [(t[5], t[0].shape[1]) for t in group]
    out = {}
    for name, fn, plain_fn, bound in (
            ("sparse_gather_catchup", catchup, plain_catchup,
             catchup_bound(shapes)),
            ("sparse_update_scatter", update, plain_update,
             scatter_bound(shapes))):
        ms = cuda_time_cold_ms(fn, iters, scratch,
                               cover_cycles=STEP_COVER_CYCLES)
        flush_ms = cuda_time_cold_ms(fn, iters, scratch, cover=False)
        plain_ms = (cuda_time_cold_ms(plain_fn, 3, scratch,
                                      cover_cycles=STEP_COVER_CYCLES)
                    if plain else None)
        out[name] = (ms, flush_ms, plain_ms, *bound)
    return out


def kernel_inputs(gen, rows, dim, touched_frac=0.5, cnt=None):
    w = 0.01 * torch.randn(rows, dim, generator=gen, device="cuda")
    g = 0.1 * torch.randn(rows, dim, generator=gen, device="cuda")
    m = 0.01 * torch.randn(rows, dim, generator=gen, device="cuda")
    v = 0.001 * torch.randn(rows, dim, generator=gen, device="cuda").abs()
    if cnt is None:
        counts = torch.randint(1, 4, (rows,), generator=gen, device="cuda")
        keep = torch.rand(rows, generator=gen, device="cuda") < touched_frac
        cnt = (counts * keep).to(torch.float32)
    return w, g, cnt, m, v


def update_bound(cnt, dim):
    """Least time for one update: every row reads its count and w and
    writes w; a touched row also reads g, m, v and writes m, v. About 21
    f32 operations per touched element, one per absent element."""
    rows = cnt.numel()
    touched = int((cnt > 0).sum())
    nbytes = touched * 28 * dim + (rows - touched) * 8 * dim + 4 * rows
    flops = touched * dim * 21 + (rows - touched) * dim
    return (*_bound(nbytes, flops), touched, nbytes)


def profiled(fn, with_stack=False):
    """Run ``fn`` once under torch.profiler: (wall ms, the profile)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts,
                                with_stack=with_stack) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, prof


def by_kernel(prof):
    """[(device ms, count, name)] of a profile's kernels and copies (not
    the device-side spans of the steps' labels), sorted by device time.
    Summed from the profiler's raw device events (what ``key_averages``
    sums, without building the op tree first: that takes minutes for the
    half a million kernels of a zamba2-2.7b prefill)."""
    totals: dict = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                or e.duration_ns() <= 0 or e.name().startswith(STEP_LABEL)):
            continue
        ms, n = totals.get(e.name(), (0.0, 0))
        totals[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return sorted(((ms, n, name) for name, (ms, n) in totals.items()),
                  reverse=True)


def device_time_by_kernel(fn):
    """Run ``fn`` once under torch.profiler: (wall ms, [(device ms, count,
    name)] sorted by device time)."""
    wall_ms, prof = profiled(fn)
    return wall_ms, by_kernel(prof)


def print_trace(prefix, tag, wall_ms, by_kernel, groups=(), steps=None):
    """Device busy time against wall time, then device time by kernel with
    its share: the top 12, and the port's own kernels wherever they rank.
    Each of ``groups``, (label, names): those kernels' device time summed,
    with its share (and per step, over ``steps`` steps)."""
    busy_ms = sum(t for t, _, _ in by_kernel)
    if not busy_ms:
        print(f"[{prefix}] {tag}: the profiler saw no device time: not "
              f"measured")
        return
    print(f"[{prefix}] {tag}: device busy {busy_ms:.1f} ms of {wall_ms:.1f} "
          f"ms wall ({100 * (1 - busy_ms / wall_ms):.1f}% idle); by kernel:")
    for rank, (ms_k, n, name) in enumerate(by_kernel):
        if rank < 12 or any(k in name for k in PORT_KERNELS):
            print(f"[{prefix}] #{rank + 1:<3d} {ms_k:9.3f} ms "
                  f"{100 * ms_k / busy_ms:5.1f}% x{n:<5d} {name[:100]}")
    for label, names in groups:
        ms_g = sum(t for t, _, name in by_kernel
                   if any(k in name for k in names))
        n_g = sum(n for _, n, name in by_kernel
                  if any(k in name for k in names))
        per_step = f", {ms_g / steps:.3f} ms a step" if steps else ""
        print(f"[{prefix}] {label} ({', '.join(names)}): {ms_g:.3f} ms"
              f"{per_step}, {100 * ms_g / busy_ms:.1f}% of device time, "
              f"{n_g} kernel launches")


STEP_LABEL = "chip_smoke step"
HOST_READ = "aten::_local_scalar_dense"   # the host reads a scalar


def torch_embedding_backward(kernels):
    """PyTorch's own embedding backward kernels among a trace's
    ``by_kernel`` rows: [(name, launches)]."""
    return [(name, n) for _, n, name in kernels
            if any(k in name for k in TORCH_EMBED_BACKWARD)]


def host_reads(prof):
    """Every host read of a scalar in a profile (the profile taken with its
    Python stack): (the traced step whose time range holds it, or "between
    the steps"; "device" when the read copies from the card (a CUDA
    runtime call under it), else "host"; the ops it was called from,
    innermost first; the innermost function of the port it was called
    from, if any, from its thread's Python stack; every caller's name)."""
    events = prof.events()
    steps = [(e.time_range.start, e.time_range.end, e.name)
             for e in events if e.name.startswith(STEP_LABEL)]
    reads = []
    for e in events:
        if e.name != HOST_READ:
            continue
        where = next((name for a, b, name in steps
                      if a <= e.time_range.start <= b), "between the steps")
        callers, stack, up = [], list(e.stack or []), e.cpu_parent
        while up is not None:
            callers.append(up.name)
            stack += up.stack or []
            up = up.cpu_parent
        ops = [c for c in callers if "::" in c][:3]
        # the Python frames are caller events or each event's recorded stack
        frame = next((c for c in callers + stack if "repro_torch" in c),
                     "no function of the port")
        below, device = list(e.cpu_children), False
        while below and not device:
            child = below.pop()
            device = child.name.startswith("cuda")
            below.extend(child.cpu_children)
        reads.append((where, "device" if device else "host",
                      " < ".join(ops) or "(called alone)", frame,
                      " ".join(callers)))
    return reads


def trace_steps(cfg, bundle, params, state, tr, tag, group):
    """2 steps through train_ctr under torch.profiler (its flush a no-op
    and no eval, so the trace holds the steps and the loop alone): device
    busy against wall time, device time by kernel, ``group``'s kernels a
    step, and every host read of a scalar with the step it fell in, whether
    it copies from the card, and the ops and port source that made it.
    Fails if any read, in a step or between the steps, copies from the
    card (a loss read in the loop, ``bincount``'s max and min), or if
    PyTorch's own embedding backward ran; and first fails unless a known
    device read and a known host read are told apart."""
    from repro_torch.train import train_ctr

    def control():    # one read of a device scalar, then of a host one
        float(torch.ones((), device="cuda"))
        float(torch.ones(()))

    kinds = sorted(r[1] for r in host_reads(profiled(control,
                                                      with_stack=True)[1]))
    check(kinds == ["device", "host"],
          f"the trace's host reads of a device and a host scalar were "
          f"classified {kinds}")

    labels = iter(range(2))

    def labelled_step(params, state, batch):
        with torch.profiler.record_function(f"{STEP_LABEL} {next(labels)}"):
            return bundle.step(params, state, batch)

    def two_steps():
        train_ctr(cfg, None, tr, None, batch_size=BATCH, seed=1,
                  step_bundle=bundle._replace(step=labelled_step,
                                              flush=lambda p, s: (p, s)),
                  max_steps=2, init_state=(params, state), device="cuda")

    wall_ms, prof = profiled(two_steps, with_stack=True)
    kernels = by_kernel(prof)
    print_trace("trace", f"{tag}, 2 steps", wall_ms, kernels,
                groups=(group, EMBED_GROUP), steps=2)
    theirs = torch_embedding_backward(kernels)
    check(not theirs, f"{tag}: PyTorch's embedding backward ran: {theirs}")
    reads = host_reads(prof)
    for where in [f"{STEP_LABEL} {i}" for i in range(2)] + [
            "between the steps"]:
        here = [r[1:4] for r in reads if r[0] == where]
        n_dev = sum(kind == "device" for kind, _, _ in here)
        print(f"[trace] {tag}, {where}: {len(here)} host reads "
              f"({HOST_READ}), {n_dev} of a device scalar")
        for read in sorted(set(here)):
            print(f"[trace]   x{here.count(read)} of a {read[0]} scalar, "
                  f"from {read[1]}, in {read[2]}")
    bad = [r[:4] for r in reads if r[1] == "device"]
    check(not bad, f"{tag}: host reads of a device scalar: {bad}")


def run_small(cfg, hp, path, dev, params0, ds, steps=3, **kw):
    """``steps`` steps of ``path`` on ``dev`` from ``params0`` over the
    first batches of ``ds``, then ``flush``; the params' leaves on the
    CPU. ``kw`` goes to ``make_bundle`` (a clip kind)."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.embed import store_for

    b = store_for(cfg, path=path).make_bundle(cfg, hp, warmup_steps=2, **kw)
    p = tree_map(lambda t: t.clone().to(dev), params0)
    s = b.init(p)
    for i in range(steps):
        sl = slice(i * 512, (i + 1) * 512)
        batch = {"ids": torch.as_tensor(ds.ids[sl], device=dev),
                 "dense": torch.as_tensor(ds.dense[sl], device=dev),
                 "labels": torch.as_tensor(ds.labels[sl], device=dev)}
        p, s, _ = b.step(p, s, batch)
    p, _ = b.flush(p, s)
    return [t.cpu() for t in tree_leaves(p)]


def ctr_phases(smi, kind):
    """Phases 3-12, the CowClip kernels and the CTR training placements.
    Returns the three kernels' JSON lines; every tensor is freed on
    return."""
    from repro_torch.configs.deepfm_criteo import CONFIG, CRITEO_VOCABS
    from repro_torch.core.scaling import scale_hyperparams
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import iterate_batches, make_ctr_dataset
    from repro_torch.embed import store_for
    from repro_torch.kernels.cowclip import (fused_cowclip_adam, reference,
                                             sparse_gather_catchup,
                                             sparse_gather_catchup_tables,
                                             sparse_update_scatter,
                                             sparse_update_scatter_tables,
                                             step_scalars)
    from repro_torch.kernels.cowclip import ref as cc_ref
    from repro_torch.kernels.embedding import (embedding_backward_groups,
                                               sort_plan)
    from repro_torch.models import ctr
    from repro_torch.train import train_ctr

    # -- 3. kernel vs plain version -------------------------------------
    phase_start(3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(r=1.0, zeta=1e-5, lr=1e-4, l2=1e-5)
    max_abs_err = [0.0]
    for rows, dim in ((10131227, 10), (10131227, 1), (4, 10)):
        for step in (1, 1000):
            w, g, cnt, m, v = kernel_inputs(gen, rows, dim)
            block = step_scalars(step, device="cuda")
            ref = reference(w, g, cnt, m, v, block, **kw)
            out = fused_cowclip_adam(w, g, cnt, m, v, block, **kw)
            torch.cuda.synchronize()
            for name, a, b in zip("wmv", out, ref):
                compare("kernel", f"[{rows}, {dim}] step {step} {name}", a, b,
                        max_abs_err)
            del w, g, cnt, m, v, ref, out
    edge_rows = 100003
    for dim in (1, 2, 3, 10, 16, 17, 64):
        for which in ("absent", "touched"):
            for step in (1, 1000):
                cnt = (torch.zeros(edge_rows, device="cuda")
                       if which == "absent" else torch.randint(
                           1, 4, (edge_rows,), generator=gen,
                           device="cuda").to(torch.float32))
                w, g, cnt, m, v = kernel_inputs(gen, edge_rows, dim, cnt=cnt)
                block = step_scalars(step, device="cuda")
                ref = reference(w, g, cnt, m, v, block, **kw)
                out = fused_cowclip_adam(w, g, cnt, m, v, block, **kw)
                torch.cuda.synchronize()
                for name, a, b in zip("wmv", out, ref):
                    compare("kernel", f"edge [{edge_rows}, {dim}] all {which} "
                            f"step {step} {name}", a, b, max_abs_err)
                del w, g, cnt, m, v, ref, out
    torch.cuda.empty_cache()

    # -- 4. train through the fused placement ---------------------------
    phase_start(4)
    cfg = dataclasses.replace(CONFIG, placement="fused", emb_sigma=1e-2)
    check(cfg.vocab_sizes == CRITEO_VOCABS and cfg.n_dense == 13
          and cfg.emb_dim == 10 and cfg.mlp_dims == (400, 400, 400),
          "not the deepfm-criteo width")
    t0 = time.perf_counter()
    tr, te = criteo_data()
    print(f"[train] synthetic Zipf data: {len(tr)} train / {len(te)} test "
          f"rows in {time.perf_counter() - t0:.1f} s", flush=True)
    hp = criteo_hypers()
    bundle = store_for(cfg).make_bundle(
        cfg, hp, warmup_steps=max(1, len(tr) // BATCH))
    n_tables = 2 * cfg.n_fields
    torch.cuda.reset_peak_memory_stats()
    fused_cowclip_adam.launches = embedding_backward_groups.launches = 0
    sort_plan.sorts = 0
    res = train_ctr(cfg, None, tr, te, batch_size=BATCH, epochs=1, seed=0,
                    step_bundle=bundle, max_steps=TRAIN_STEPS, device="cuda")
    torch.cuda.synchronize()
    launches = fused_cowclip_adam.launches
    embed_runs = embedding_backward_groups.launches
    MAIN_PATH_LAUNCHES["embedding_backward"] = embed_runs
    n_ids = sum(CRITEO_VOCABS)
    print(f"[train] deepfm-criteo fused: {n_ids} ids x (10 + 1), batch "
          f"{BATCH}, {res.steps} steps, kernel launches {launches} "
          f"(expected {n_tables} x {TRAIN_STEPS}); embedding backward runs "
          f"{embed_runs} (expected 1 x {TRAIN_STEPS}: the fm and the LR "
          f"lookup in one call), its sorts {sort_plan.sorts} (expected "
          f"{TRAIN_STEPS})")
    for i, (loss, sec) in enumerate(zip(res.losses, res.step_seconds)):
        print(f"[train] step {i + 1}: loss {loss:.6f} {sec * 1e3:.1f} ms")
    steady = res.step_seconds[1:]
    print(f"[train] ms/step after the first (CUDA events): "
          f"{1e3 * sum(steady) / len(steady):.1f}; eval AUC "
          f"{res.final_eval['auc']:.6f} logloss "
          f"{res.final_eval['logloss']:.6f} "
          f"({res.final_eval['eval_rows_per_sec']:.0f} rows/s); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    check(res.steps == TRAIN_STEPS, f"ran {res.steps} steps")
    check(launches == n_tables * TRAIN_STEPS,
          f"kernel launched {launches} times, expected "
          f"{n_tables * TRAIN_STEPS}")
    check(embed_runs == TRAIN_STEPS and sort_plan.sorts == TRAIN_STEPS,
          f"embedding backward ran {embed_runs} times with "
          f"{sort_plan.sorts} sorts")
    check(all(math.isfinite(x) for x in res.losses), "non-finite loss")
    auc = res.final_eval["auc"]
    check(math.isfinite(auc) and 0.0 <= auc <= 1.0, f"AUC {auc}")
    for leaf in tree_leaves(res.params):
        check(bool(torch.isfinite(leaf).all()), "non-finite params")
    big_field = int(np.argmax(CRITEO_VOCABS))
    step_cnt = torch.bincount(
        torch.as_tensor(tr.ids[:BATCH, big_field], device="cuda"),
        minlength=CRITEO_VOCABS[big_field]).to(torch.float32)

    # -- 5. where a step's device time goes (2 more steps, profiled) -----
    phase_start(5)
    # after the launch count was read, so these launches are not counted
    trace_steps(cfg, bundle, res.params, res.opt_state, tr, "fused",
                ("the fused update's kernels", FUSED_KERNELS))
    del res, bundle
    torch.cuda.empty_cache()

    # -- 6. agreement with the CPU path on a small input -----------------
    phase_start(6)
    small = ctr.CTRConfig(name="deepfm", vocab_sizes=(2000, 700, 120, 30, 5),
                          n_dense=4, emb_dim=8, mlp_dims=(32, 32, 32),
                          emb_sigma=1e-2, placement="fused")
    sds = make_ctr_dataset(3 * 512, small.vocab_sizes, n_dense=4, seed=1)
    shp = scale_hyperparams("cowclip", base_lr=1e-3, base_l2=1e-5,
                            base_batch=256, batch_size=512,
                            base_dense_lr=2e-3)
    params0 = ctr.init(small, seed=1, device="cpu")
    runs = {dev: run_small(small, shp, "fused", dev, params0, sds)
            for dev in ("cpu", "cuda")}
    worst = max((a - c).abs().max().item()
                for a, c in zip(runs["cuda"], runs["cpu"]))
    agree = all(torch.allclose(a, c, rtol=1e-5, atol=1e-5)
                for a, c in zip(runs["cuda"], runs["cpu"]))
    print(f"[agree] 3 fused steps, card vs CPU plain path: max_abs {worst:.3e}"
          f" (rtol 1e-5, atol 1e-5) {'ok' if agree else 'FAIL'}")
    check(agree, "card and CPU paths disagree on a small input")

    # -- 7. kernel time on the largest table ----------------------------
    phase_start(7)
    rows, dim = CRITEO_VOCABS[big_field], CONFIG.emb_dim
    step_kw = dict(r=1.0, zeta=1e-5, lr=hp.emb_lr, l2=hp.emb_l2)
    # L2 flushed before each launch, the host's work covered: at D = 1 a
    # launch is shorter than the wrapper's host work, which back-to-back
    # launches would time
    timings = {}
    scratch = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    from repro_torch.kernels import cowclip as cc

    block5 = step_scalars(5, device="cuda")
    for label, dim, cnt in (("one batch's counts", dim, step_cnt),
                            ("half touched", dim, None),
                            ("one batch's counts", 1, step_cnt)):
        w, g, cnt, m, v = kernel_inputs(gen, rows, dim, cnt=cnt)

        def run():
            fused_cowclip_adam(w, g, cnt, m, v, block5, **step_kw)

        ms = cuda_time_cold_ms(run, 20, scratch)
        flush_ms = cuda_time_cold_ms(run, 20, scratch, cover=False)
        plain_ms = cuda_time_cold_ms(lambda: reference(
            w, g, cnt, m, v, block5, **step_kw), 5, scratch)
        bound_ms, bound_by, touched, nbytes = update_bound(cnt, dim)
        timings[label, dim] = (ms, plain_ms, bound_ms, bound_by)
        print(f"[time] [{rows}, {dim}] {label} ({touched} rows touched, L2 "
              f"flushed): "
              f"kernel {ms:.4f} ms ({flush_ms:.4f} ms with the flush alone, "
              f"host work not covered), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s), {kind} at "
              f"{smi.strip().split(', ')[-1]}", flush=True)
        del w, g, cnt, m, v
    del scratch
    ms, plain_ms, bound_ms, bound_by = timings["one batch's counts",
                                               CONFIG.emb_dim]
    fused_line = {
        "name": "cowclip_adam_update",
        "route": "cuda",
        "source": "src/repro_torch/kernels/cowclip/csrc/cowclip_adam.cu",
        "replaces": "src/repro/kernels/cowclip/cowclip.py:72",
        "launches": launches,
        "max_abs_err": max_abs_err[0],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }
    torch.cuda.empty_cache()

    # -- 8. sparse kernels vs their plain versions ----------------------
    phase_start(8)
    vocab = CRITEO_VOCABS[big_field]
    cap = min(BATCH, vocab)
    col = torch.as_tensor(tr.ids[:BATCH, big_field], device="cuda")
    uids_big, counts_big = slot_set(col, vocab, cap)
    shard_rows = -(-vocab // 4)            # the last of 4 row shards
    shard_off = 3 * shard_rows
    shard_uids, shard_counts = slot_set(col, vocab, min(BATCH, shard_rows),
                                        lo=shard_off)
    small_uids, small_counts = slot_set(
        torch.tensor([0, 2, 2], device="cuda"), 4, 4)
    sparse_kw = dict(lr=hp.emb_lr, l2=hp.emb_l2)
    print(f"[sparse-kernel] largest field: {int((counts_big > 0).sum())} "
          f"real slots of {cap}; last shard [{shard_off}, "
          f"{shard_off + shard_rows}): {int((shard_counts > 0).sum())} real "
          f"slots, pad uid {vocab} -> row {vocab - shard_off}; lr "
          f"{hp.emb_lr} l2 {hp.emb_l2}", flush=True)
    err_c, err_u = [0.0], [0.0]
    cases = (("[%d, 10]" % vocab, vocab, 10, uids_big, counts_big, 0),
             ("[%d, 1]" % vocab, vocab, 1, uids_big, counts_big, 0),
             ("[4, 10]", 4, 10, small_uids, small_counts, 0),
             ("shard [%d, 10] offset %d" % (shard_rows, shard_off),
              shard_rows, 10, shard_uids, shard_counts, shard_off))
    for label, rows, dim, uids, counts, off in cases:
        real = counts > 0
        for step in (1, 1000):
            w, m, v, ls = sparse_tables(gen, rows, dim, 1000)
            kw = dict(sparse_kw, row_offset=off)
            block = step_scalars(step, device="cuda")
            got = sparse_gather_catchup(w, m, v, ls, uids, counts, block,
                                        **kw)
            want = cc_ref.sparse_gather_catchup_reference(
                w, m, v, ls, uids, block, **kw)
            torch.cuda.synchronize()
            for name, a, b in zip("wmv", got, want):
                check(bool(torch.isfinite(a).all()),
                      f"non-finite catch-up rows at {label}")
                compare("sparse-kernel", f"catch-up {label} step {step} "
                        f"{name}_rows (real slots)", a[real], b[real], err_c)
            g = 0.1 * torch.randn(counts.numel(), dim, generator=gen,
                                  device="cuda")
            tables = [t.clone() for t in (w, m, v, ls)]
            upd = (uids, counts, got[0], g, got[1], got[2], block)
            sparse_update_scatter(*tables, *upd, r=1.0, zeta=1e-5, **kw)
            want = cc_ref.sparse_update_scatter_reference(
                w, m, v, ls, *upd, r=1.0, zeta=1e-5, **kw)
            torch.cuda.synchronize()
            for name, a, b in zip("wmv", tables, want):
                compare("sparse-kernel", f"update {label} step {step} table "
                        f"{name}", a, b, err_u)
            check(torch.equal(tables[3], want[3]),
                  f"last_step differs from the plain version at {label}")
            untouched = torch.ones(rows, dtype=torch.bool, device="cuda")
            untouched[uids[real].to(torch.int64) - off] = False
            check(all(torch.equal(a[untouched], b[untouched])
                      for a, b in zip(tables, (w, m, v, ls))),
                  f"the update wrote an untouched row at {label}")
            print(f"[sparse-kernel] update {label} step {step}: "
                  f"{int(untouched.sum())} untouched rows bitwise unchanged",
                  flush=True)
            del w, m, v, ls, got, want, tables, g, untouched
        torch.cuda.empty_cache()

    # the grouped launch over the 52 tables of phase 9's first batch (the
    # main path's form)
    batch_ids = torch.as_tensor(
        next(iterate_batches(tr, BATCH, seed=0))["ids"], device="cuda")
    slot_sets = step_slot_sets(batch_ids, CRITEO_VOCABS)
    dims = (CONFIG.emb_dim, 1)
    for step in (1, 1000):
        group = step_tables(gen, CRITEO_VOCABS, slot_sets, dims, 1000)
        cols = [list(c) for c in zip(*group)]       # w, m, v, ls, uids, counts
        block = step_scalars(step, device="cuda")
        rows, depth = sparse_gather_catchup_tables(*cols, block, **sparse_kw)
        grads = [0.1 * torch.randn(r[0].shape, generator=gen, device="cuda")
                 for r in rows]
        tables = [[t.clone() for t in c] for c in cols[:4]]
        sparse_update_scatter_tables(
            *tables, cols[4], cols[5], [r[0] for r in rows], grads,
            [r[1] for r in rows], [r[2] for r in rows], block, r=1.0,
            zeta=1e-5, **sparse_kw)
        torch.cuda.synchronize()
        # the step's former depth diagnostic, table by table
        stacked = torch.stack([
            torch.max(torch.where(
                c > 0, (step - 1) - ls[torch.clamp_max(u.to(torch.int64),
                                                       ls.shape[0] - 1)], 0))
            for _, _, _, ls, u, c in group]).max().to(torch.int32)
        check(int(depth) == int(stacked),
              f"grouped depth {int(depth)} != {int(stacked)} at step {step}")
        worst_rows, worst_tables, untouched_rows = [0.0], [0.0], 0
        for i, (w, m, v, ls, uids, counts) in enumerate(group):
            tag = f"grouped step {step}, table {i} [{w.shape[0]}, " \
                  f"{w.shape[1]}]"
            real = counts > 0
            want = cc_ref.sparse_gather_catchup_reference(
                w, m, v, ls, uids, block, **sparse_kw)
            for name, a, b in zip("wmv", rows[i], want):
                check(bool(torch.isfinite(a).all()),
                      f"non-finite catch-up rows, {tag}")
                compare(None, f"catch-up {tag} {name}_rows (real slots)",
                        a[real], b[real], worst_rows)
            want = cc_ref.sparse_update_scatter_reference(
                w, m, v, ls, uids, counts, rows[i][0], grads[i], rows[i][1],
                rows[i][2], block, r=1.0, zeta=1e-5, **sparse_kw)
            got = [t[i] for t in tables]
            for name, a, b in zip("wmv", got, want):
                compare(None, f"update {tag} table {name}", a, b,
                        worst_tables)
            check(torch.equal(got[3], want[3]),
                  f"last_step differs from the plain version, {tag}")
            untouched = torch.ones(w.shape[0], dtype=torch.bool,
                                   device="cuda")
            untouched[uids[real].to(torch.int64)] = False
            check(all(torch.equal(a[untouched], b[untouched])
                      for a, b in zip(got, (w, m, v, ls))),
                  f"the update wrote an untouched row, {tag}")
            untouched_rows += int(untouched.sum())
            del want, got, untouched
        err_c[0] = max(err_c[0], worst_rows[0])
        err_u[0] = max(err_u[0], worst_tables[0])
        print(f"[sparse-kernel] grouped, step {step}, {len(group)} tables "
              f"in one launch each: catch-up rows on the real slots max_abs "
              f"{worst_rows[0]:.3e}, tables after the update max_abs "
              f"{worst_tables[0]:.3e} (rtol {RTOL}, atol {ATOL}) ok; "
              f"last_step equal; {untouched_rows} untouched rows bitwise "
              f"unchanged; depth {int(depth)} = the per-table formula's",
              flush=True)
        del group, cols, rows, depth, grads, tables, stacked, block
        torch.cuda.empty_cache()

    # -- 9. train through the sparse placement ---------------------------
    phase_start(9)
    cfg_s = dataclasses.replace(CONFIG, placement="sparse", emb_sigma=1e-2)
    sbundle = store_for(cfg_s).make_bundle(
        cfg_s, hp, warmup_steps=max(1, len(tr) // BATCH))
    depths = []

    def recorded_step(params, state, batch):
        params, state, aux = sbundle.step(params, state, batch)
        depths.append(aux["catchup_depth_max"])
        return params, state, aux

    torch.cuda.reset_peak_memory_stats()
    counters = (sparse_gather_catchup_tables, sparse_update_scatter_tables,
                sparse_gather_catchup, sparse_update_scatter,
                fused_cowclip_adam)
    for wrapper in counters + (embedding_backward_groups,):
        wrapper.launches = 0
    sort_plan.sorts = 0
    sres = train_ctr(cfg_s, None, tr, te, batch_size=BATCH, epochs=1,
                     seed=0, step_bundle=sbundle._replace(step=recorded_step),
                     max_steps=TRAIN_STEPS, device="cuda")
    torch.cuda.synchronize()
    s_launches = (sparse_gather_catchup_tables.launches,
                  sparse_update_scatter_tables.launches)
    other_launches = tuple(w.launches for w in counters[2:])
    print(f"[sparse-train] deepfm-criteo sparse: batch {BATCH}, {sres.steps} "
          f"steps, {n_tables} tables; launches: sparse_gather_catchup "
          f"{s_launches[0]}, sparse_update_scatter {s_launches[1]} "
          f"(expected 1 a step each, {TRAIN_STEPS}); single-table "
          f"wrappers {other_launches[:2]} and cowclip_adam "
          f"{other_launches[2]} (expected 0)")
    for i, (loss, sec, depth) in enumerate(zip(sres.losses,
                                               sres.step_seconds, depths)):
        print(f"[sparse-train] step {i + 1}: loss {loss:.6f} "
              f"{sec * 1e3:.1f} ms, catchup_depth_max {int(depth)}")
    steady = sres.step_seconds[1:]
    print(f"[sparse-train] ms/step after the first (CUDA events): "
          f"{1e3 * sum(steady) / len(steady):.1f}; eval AUC "
          f"{sres.final_eval['auc']:.6f} logloss "
          f"{sres.final_eval['logloss']:.6f} "
          f"({sres.final_eval['eval_rows_per_sec']:.0f} rows/s); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    check(sres.steps == TRAIN_STEPS, f"sparse ran {sres.steps} steps")
    check(s_launches == (TRAIN_STEPS,) * 2,
          f"sparse kernels launched {s_launches} times, expected "
          f"{TRAIN_STEPS} each")
    check(other_launches == (0, 0, 0),
          f"single-table sparse and fused launches {other_launches} on the "
          f"sparse path")
    print(f"[sparse-train] embedding backward runs "
          f"{embedding_backward_groups.launches} (expected 1 x {TRAIN_STEPS}:"
          f" the fm and the LR slot rows in one call), its sorts "
          f"{sort_plan.sorts} (expected 0: the dedups' order)")
    check(embedding_backward_groups.launches == TRAIN_STEPS
          and sort_plan.sorts == 0,
          f"embedding backward ran {embedding_backward_groups.launches} times "
          f"with {sort_plan.sorts} sorts on the sparse path")
    check(all(math.isfinite(x) for x in sres.losses), "non-finite sparse loss")
    auc = sres.final_eval["auc"]
    check(math.isfinite(auc) and 0.0 <= auc <= 1.0, f"sparse AUC {auc}")
    for leaf in tree_leaves(sres.params):
        check(bool(torch.isfinite(leaf).all()), "non-finite sparse params")

    # -- 10. where a sparse step's device time goes ----------------------
    phase_start(10)
    trace_steps(cfg_s, sbundle, sres.params, sres.opt_state, tr, "sparse",
                ("the sparse pair's kernels", SPARSE_KERNELS))
    del sres, sbundle, tr, te
    torch.cuda.empty_cache()

    # -- 11. sparse agreement on a small input ---------------------------
    phase_start(11)
    # l2 large enough that the per-step decay factor is not 1.0 in f32,
    # so the catch-up has work
    shp_s = scale_hyperparams("cowclip", base_lr=1e-3, base_l2=1e-3,
                              base_batch=256, batch_size=512,
                              base_dense_lr=2e-3)
    small_s = dataclasses.replace(small, placement="sparse")
    cpu_s = run_small(small_s, shp_s, "sparse", "cpu", params0, sds)
    card_s = run_small(small_s, shp_s, "sparse", "cuda", params0, sds)
    card_s2 = run_small(small_s, shp_s, "sparse", "cuda", params0, sds)
    card_f = run_small(small_s, shp_s, "fused", "cuda", params0, sds)
    for what, a_run, b_run in (("card vs CPU plain path", card_s, cpu_s),
                               ("flushed sparse vs fused, card", card_s,
                                card_f)):
        worst = max((a - c).abs().max().item() for a, c in zip(a_run, b_run))
        agree = all(torch.allclose(a, c, rtol=1e-5, atol=1e-5)
                    for a, c in zip(a_run, b_run))
        print(f"[sparse-agree] 3 sparse steps + flush, {what}: max_abs "
              f"{worst:.3e} (rtol 1e-5, atol 1e-5) "
              f"{'ok' if agree else 'FAIL'}")
        check(agree, f"sparse {what} disagree on a small input")
    same = all(torch.equal(a, c) for a, c in zip(card_s, card_s2))
    print(f"[sparse-agree] the same 3 sparse steps twice on the card: "
          f"{'bitwise equal' if same else 'DIFFER'}")
    check(same, "two identical sparse runs on the card differ")

    # -- 12. sparse kernel times on the largest table --------------------
    phase_start(12)
    scratch = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    sparse_times = {}
    block1000 = step_scalars(1000, device="cuda")
    for dim in (CONFIG.emb_dim, 1):
        w, m, v, ls = sparse_tables(gen, vocab, dim, 1000)
        g = 0.1 * torch.randn(cap, dim, generator=gen, device="cuda")
        rows_c = sparse_gather_catchup(w, m, v, ls, uids_big, counts_big,
                                       block1000, **sparse_kw)
        upd = (uids_big, counts_big, rows_c[0], g, rows_c[1], rows_c[2],
               block1000)
        runs = {
            "sparse_gather_catchup": (
                lambda: sparse_gather_catchup(w, m, v, ls, uids_big,
                                              counts_big, block1000,
                                              **sparse_kw),
                lambda: cc_ref.sparse_gather_catchup_reference(
                    w, m, v, ls, uids_big, block1000, **sparse_kw),
                catchup_bound([(counts_big, dim)])),
            "sparse_update_scatter": (
                lambda: sparse_update_scatter(w, m, v, ls, *upd, r=1.0,
                                              zeta=1e-5, **sparse_kw),
                lambda: cc_ref.sparse_update_scatter_reference(
                    w, m, v, ls, *upd, r=1.0, zeta=1e-5, **sparse_kw),
                scatter_bound([(counts_big, dim)])),
        }
        for name, (kernel_fn, plain_fn, bound) in runs.items():
            k_ms = cuda_time_cold_ms(kernel_fn, 20, scratch)
            f_ms = cuda_time_cold_ms(kernel_fn, 20, scratch, cover=False)
            p_ms = cuda_time_cold_ms(plain_fn, 5, scratch)
            b_ms, b_by, real, nbytes = bound
            sparse_times[name, dim] = (k_ms, p_ms, b_ms, b_by)
            print(f"[time] {name} [{vocab}, {dim}] cap {cap} ({real} real "
                  f"slots, L2 flushed): kernel {k_ms:.4f} ms ({f_ms:.4f} ms "
                  f"with the flush alone, host work not covered), plain "
                  f"{p_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({nbytes} B "
                  f"at {HBM_BYTES_PER_S / 1e12} TB/s), {kind} at "
                  f"{smi.strip().split(', ')[-1]}", flush=True)
        del w, m, v, ls, g, rows_c, upd, runs
    torch.cuda.empty_cache()
    # one step's 52 tables: the grouped launch (the main path's), and the
    # same kernel through the single-table wrappers, a launch a table
    power = smi.strip().split(", ")[-1]
    per_table = types.SimpleNamespace(
        sparse_gather_catchup=sparse_gather_catchup,
        sparse_update_scatter=sparse_update_scatter)
    for form, module, plain in (("one grouped launch", cc, True),
                                (f"{n_tables} single-table launches",
                                 per_table, False)):
        times = time_sparse_step(module, gen, CRITEO_VOCABS, slot_sets, dims,
                                 scratch, block1000, plain=plain,
                                 **sparse_kw)
        torch.cuda.empty_cache()
        for name, (k_ms, f_ms, p_ms, b_ms, b_by, real, nbytes) in \
                times.items():
            if plain:
                sparse_times[name, "step"] = (k_ms, p_ms, b_ms, b_by)
            plain_txt = f", plain {p_ms:.4f} ms" if plain else ""
            print(f"[time] {name}, one step's {n_tables} tables ({real} real "
                  f"slots), {form}, L2 flushed: {k_ms:.4f} ms, host work "
                  f"covered ({f_ms:.4f} ms with the flush alone){plain_txt}, "
                  f"bound {b_ms:.4f} ms by {b_by} ({nbytes} B at "
                  f"{HBM_BYTES_PER_S / 1e12} TB/s), {kind} at {power}",
                  flush=True)
    del scratch

    lines = [fused_line]
    for name, source, replaces, n, err in (
            ("sparse_gather_catchup", "sparse_catchup.cu", 93, s_launches[0],
             err_c[0]),
            ("sparse_update_scatter", "sparse_update.cu", 179, s_launches[1],
             err_u[0])):
        k_ms, p_ms, b_ms, b_by = sparse_times[name, "step"]
        lines.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/cowclip/csrc/{source}",
            "replaces": f"src/repro/kernels/cowclip/sparse.py:{replaces}",
            "launches": n,
            "max_abs_err": err,
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    return lines


def tree_diff(a, b):
    """The leaves of two trees of tensors that are not bitwise equal:
    [(path, elements that differ, max abs difference)]."""
    from repro_torch.core.tree import flatten_with_paths

    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    check(fa.keys() == fb.keys(), "the trees differ in structure")
    return [(k, int(fa[k].ne(fb[k]).sum()),
             float(f"{(fa[k].double() - fb[k].double()).abs().max():.2e}"))
            for k in fa if not torch.equal(fa[k], fb[k])]


def steady_ms(bundle, runner, params, state, chunk, rounds=TIMED_CHUNKS):
    """Steady-state ms/step of the eager steps and the graph: ``rounds``
    rounds, each one replay of ``chunk`` through ``runner`` and then its
    SCAN_STEPS batches through ``bundle.step`` (the batches already on the
    card, so neither side copies from the host), CUDA events around each
    chunk's steps. Returns (eager, graph), each a list of ms a step, one a
    chunk."""
    batches = [{k: v[i] for k, v in chunk.items()}
               for i in range(SCAN_STEPS)]

    def eager_chunk():
        for batch in batches:
            bundle.step(params, state, batch)

    spans = {"eager": [], "graph": []}
    for _ in range(rounds):
        for name, fn in (("graph", lambda: runner(params, state, chunk)),
                         ("eager", eager_chunk)):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            spans[name].append((a, b))
    torch.cuda.synchronize()
    return tuple([a.elapsed_time(b) / SCAN_STEPS for a, b in spans[name]]
                 for name in ("eager", "graph"))


def spread(ms):
    """'mean (median, min-max, n)' of a list of ms."""
    a = np.asarray(ms)
    return (f"{a.mean():.3f} (median {np.median(a):.3f}, {a.min():.3f}-"
            f"{a.max():.3f}, {a.size} chunks)")


def graph_engine_phase(placement, tr, hp, power, kind):
    """Phase 19 (fused) or 20 (sparse): GRAPH_STEPS steps of
    ``train_ctr`` at deepfm-criteo width and batch BATCH with the eager
    engine, again, and with the scan engine (SCAN_STEPS steps a captured
    graph), from the same params over the same batches, under PyTorch's
    default algorithms: params, moments, the state's counters and the
    losses must be bitwise equal across the three runs (for the fused
    placement one step's gradients computed twice are compared first).
    Then one chunk's replay, traced: its kernels by name (the update's
    launches a step, the embedding backward's; CUPTI traces a graph's
    kernels; none of PyTorch's embedding backward), its host reads of
    scalars (none allowed) and its idle share; and the steady state,
    ``steady_ms``. Returns (cfg, bundle, params, state) of the scan run."""
    from repro_torch.configs.deepfm_criteo import CONFIG
    from repro_torch.core.tree import tree_map
    from repro_torch.data.prefetch import chunk_epoch
    from repro_torch.embed import store_for
    from repro_torch.kernels import cowclip as cc
    from repro_torch.kernels.embedding import (embedding_backward_groups,
                                               ref, sort_plan)
    from repro_torch.models import ctr
    from repro_torch.train import engine as engine_lib
    from repro_torch.train import train_ctr

    tag = f"graph-{placement}"
    cfg = dataclasses.replace(CONFIG, placement=placement, emb_sigma=1e-2)
    bundle = store_for(cfg).make_bundle(
        cfg, hp, warmup_steps=max(1, len(tr) // BATCH))
    params0 = ctr.init(cfg, seed=7, device="cuda")
    check(not torch.are_deterministic_algorithms_enabled(),
          "deterministic algorithms are on")

    def run(engine):
        params = tree_map(torch.clone, params0)
        return train_ctr(
            cfg, None, tr, None, batch_size=BATCH, seed=3,
            step_bundle=bundle, max_steps=GRAPH_STEPS, engine=engine,
            scan_steps=SCAN_STEPS, init_state=(params, bundle.init(params)),
            device="cuda")

    if placement == "fused":
        from repro_torch.data import iterate_batches
        from repro_torch.train.loop import _loss_and_grads

        batch = {k: torch.as_tensor(v, device="cuda") for k, v in
                 next(iterate_batches(tr, BATCH, seed=3)).items()}
        grads = [_loss_and_grads(params0, cfg, batch)[1] for _ in range(2)]
        differ = tree_diff(*grads)
        print(f"[{tag}] one step's gradients twice, same params and batch, "
              f"default algorithms: "
              f"{'bitwise equal' if not differ else f'DIFFER at {differ}'} "
              f"(vocab of each field: {list(cfg.vocab_sizes)})", flush=True)
        check(not differ, "one step's gradients differ run to run")
        del batch, grads
    embedding_backward_groups.launches = sort_plan.sorts = 0
    eager = run("eager")
    embed_runs, embed_sorts = embedding_backward_groups.launches, sort_plan.sorts
    again = run("eager")
    leaves = lambda r: (r.params, r.opt_state)  # noqa: E731
    runs_differ = tree_diff(leaves(eager), leaves(again))
    same_losses = eager.losses == again.losses
    del again
    scan = run("scan")
    check(eager.steps == scan.steps == GRAPH_STEPS,
          f"{placement}: {eager.steps} / {scan.steps} steps")
    graph_differ = tree_diff(leaves(eager), leaves(scan))
    eager_ms = 1e3 * sum(eager.step_seconds[1:]) / (GRAPH_STEPS - 1)
    graph_ms = 1e3 * sum(scan.step_seconds[SCAN_STEPS:]) / (
        GRAPH_STEPS - SCAN_STEPS)
    first_ms = 1e3 * scan.step_seconds[0]
    print(f"[{tag}] deepfm-criteo {placement}, batch {BATCH}, "
          f"{GRAPH_STEPS} steps, PyTorch's default algorithms: eager "
          f"against eager: "
          f"{'bitwise equal' if not runs_differ else f'DIFFER at {runs_differ[:6]}'}"
          f", losses {'equal' if same_losses else 'DIFFER'}; eager against "
          f"the scan engine ({SCAN_STEPS} steps a graph): params and state "
          f"{'bitwise equal' if not graph_differ else f'DIFFER at {graph_differ[:6]}'}"
          f", losses "
          f"{'bitwise equal' if eager.losses == scan.losses else 'DIFFER'} "
          f"(last {scan.losses[-1]:.6f})", flush=True)
    print(f"[{tag}] train_ctr's ms/step (CUDA events, input pipeline "
          f"included): eager {eager_ms:.2f} (steps 2-{GRAPH_STEPS}: "
          f"{[round(1e3 * x, 2) for x in eager.step_seconds]}), graph "
          f"{graph_ms:.2f} (its one chunk after the first; the first, its "
          f"capture included, {first_ms:.1f} ms a step), {kind} at {power}",
          flush=True)
    want_sorts = GRAPH_STEPS if placement == "fused" else 0
    print(f"[{tag}] eager run: embedding backward runs {embed_runs} "
          f"(expected {GRAPH_STEPS}, one a step), its sorts {embed_sorts} "
          f"(expected {want_sorts})", flush=True)
    check(embed_runs == GRAPH_STEPS and embed_sorts == want_sorts,
          f"{placement}: embedding backward runs {embed_runs}, sorts "
          f"{embed_sorts}")
    check(not runs_differ and same_losses,
          f"{placement}: two eager runs differ under the default algorithms")
    check(not graph_differ and eager.losses == scan.losses,
          f"{placement}: the graph replays differ from the eager steps")
    del eager
    params, state = scan.params, scan.opt_state
    del scan, params0
    torch.cuda.empty_cache()

    # one chunk's replay, traced, through a runner of its own
    chunk = {k: torch.as_tensor(v, device="cuda") for k, v in
             next(chunk_epoch(tr, BATCH, SCAN_STEPS, seed=4)).items()}
    runner = engine_lib.make_chunk_runner(bundle.step.scan_step)
    wrappers = (cc.fused_cowclip_adam, cc.sparse_gather_catchup,
                cc.sparse_update_scatter, cc.sparse_gather_catchup_tables,
                cc.sparse_update_scatter_tables)
    for w in wrappers:
        w.launches = 0
    runner(params, state, chunk)          # the capture and a first replay
    torch.cuda.synchronize()
    calls = [w.launches for w in wrappers]
    wall_ms, prof = profiled(lambda: runner(params, state, chunk))
    kernels = by_kernel(prof)
    group = (FUSED_KERNELS if placement == "fused" else SPARSE_KERNELS)
    print_trace(tag, f"one replay of {SCAN_STEPS} steps", wall_ms, kernels,
                groups=(("the update's kernels", group), EMBED_GROUP),
                steps=SCAN_STEPS)
    counts = {n: sum(c for _, c, k in kernels if n in k)
              for n in FUSED_KERNELS + SPARSE_KERNELS + EMBED_KERNELS}
    theirs = torch_embedding_backward(kernels)
    reads = sum(e.name == HOST_READ for e in prof.events())
    n_tables = 2 * cfg.n_fields
    want = ({"cowclip_adam_tile_kernel": 0, "cowclip_adam_kernel": 0,
             "sparse_catchup_kernel": SCAN_STEPS,
             "sparse_update_kernel": SCAN_STEPS} if placement == "sparse"
            else {"sparse_catchup_kernel": 0, "sparse_update_kernel": 0})
    fused = sum(counts[n] for n in FUSED_KERNELS)
    levels = ref.levels(BATCH * cfg.n_fields)
    print(f"[{tag}] kernels of one replay (CUPTI sees a graph's kernels): "
          f"{counts} ({counts[EMBED_KERNELS[0]] / SCAN_STEPS:g} embedding "
          f"backward level launches a step, expected {levels}: one run a "
          f"step); PyTorch's "
          f"embedding backward kernels {theirs}; host reads of a scalar in "
          f"the replay {reads}; wrapper calls for the warm-up step and the "
          f"capture (fused, single-table catch-up and update, grouped "
          f"catch-up and update) {calls}", flush=True)
    check(reads == 0, f"{placement}: {reads} host reads in a replay")
    check(not theirs, f"{placement}: PyTorch's embedding backward in a "
          f"replay: {theirs}")
    check(counts[EMBED_KERNELS[0]] == levels * SCAN_STEPS,
          f"{placement}: {counts[EMBED_KERNELS[0]]} embedding backward "
          f"level launches in a replay, expected {levels} a step")
    check(all(counts[n] == v for n, v in want.items()),
          f"{placement}: kernels a replay {counts}, expected {want}")
    if placement == "fused":
        check(fused == n_tables * SCAN_STEPS,
              f"fused update launched {fused} times in a replay of "
              f"{SCAN_STEPS} steps, expected {n_tables} a step")
    else:
        check(calls[0] == calls[1] == calls[2] == 0,
              f"single-table or fused wrappers called {calls[:3]} on the "
              f"sparse graph")
    del prof

    eager_ms, graph_ms = steady_ms(bundle, runner, params, state, chunk)
    print(f"[{tag}] steady ms/step (default algorithms; CUDA events around "
          f"each chunk of {SCAN_STEPS} steps on batches already on the card, "
          f"eager and graph in turns): eager {spread(eager_ms)}, graph "
          f"{spread(graph_ms)}, {kind} at {power}", flush=True)
    check(all(math.isfinite(x) and x > 0 for x in eager_ms + graph_ms),
          f"{placement}: a steady chunk time is not positive")
    del runner, chunk
    torch.cuda.empty_cache()
    return cfg, bundle, params, state


def guard_phase(power, kind):
    """Phase 21: a chunk of 4 batches at phase 6's small size, the second
    with a NaN dense feature, under nonfinite_guard on both placements:
    the poisoned eager step leaves params, moments, last_step and step
    bitwise unchanged, and the graph's replay equals the eager steps bit
    for bit, its skipped_steps summing to 1."""
    from repro_torch.core.scaling import scale_hyperparams
    from repro_torch.core.tree import tree_map
    from repro_torch.data import make_ctr_dataset
    from repro_torch.data.prefetch import chunk_epoch
    from repro_torch.embed import store_for
    from repro_torch.models import ctr
    from repro_torch.train import engine as engine_lib

    shp = scale_hyperparams("cowclip", base_lr=1e-3, base_l2=1e-3,
                            base_batch=256, batch_size=512,
                            base_dense_lr=2e-3)
    for placement in ("fused", "sparse"):
        cfg = ctr.CTRConfig(name="deepfm",
                            vocab_sizes=(2000, 700, 120, 30, 5), n_dense=4,
                            emb_dim=8, mlp_dims=(32, 32, 32), emb_sigma=1e-2,
                            placement=placement)
        sds = make_ctr_dataset(4 * 512, cfg.vocab_sizes, n_dense=4, seed=1)
        bundle = store_for(cfg).make_bundle(cfg, shp, warmup_steps=2,
                                            nonfinite_guard=True)
        chunk = next(chunk_epoch(sds, 512, 4, seed=1))
        chunk["dense"][1, 0, 0] = np.nan
        chunk = {k: torch.as_tensor(v, device="cuda")
                 for k, v in chunk.items()}
        params0 = ctr.init(cfg, seed=1, device="cuda")

        p = tree_map(torch.clone, params0)
        s = bundle.init(p)
        skipped, unchanged = [], True
        for i in range(4):
            before = tree_map(torch.clone, (p, s)) if i == 1 else None
            p, s, aux = bundle.step(p, s, {k: v[i] for k, v in chunk.items()})
            skipped.append(int(aux["skipped_steps"]))
            if before is not None:
                unchanged = not tree_diff(before, (p, s))
        eager = (p, s)
        p = tree_map(torch.clone, params0)
        s = bundle.init(p)
        runner = engine_lib.make_chunk_runner(bundle.step.scan_step)
        p, s, aux = runner(p, s, chunk)
        diff = tree_diff(eager, (p, s))
        n_skipped = int(aux["skipped_steps"].sum())
        print(f"[guard] {placement}, a NaN batch 2nd of 4: eager skipped "
              f"{skipped}, the poisoned step left params and state "
              f"{'bitwise unchanged' if unchanged else 'CHANGED'}; graph "
              f"replay skipped {n_skipped}, step {int(s['step'])}, "
              f"{'bitwise equal to' if not diff else 'DIFFERS from'} the "
              f"eager steps", flush=True)
        check(skipped == [0, 1, 0, 0] and unchanged and n_skipped == 1
              and int(s["step"]) == 3 and not diff,
              f"{placement}: the guard under a graph is not the eager "
              f"guard's skip ({diff[:4]})")


def serving_phase(cfg, bundle, params, state, tr, te, power, kind):
    """Phase 22: a ServingEngine over the fused bundle's snapshot at full
    width, one captured graph at SERVE_BATCH rows: requests of
    SERVE_SIZES rows against the eager forward, a MicroBatcher behind
    SERVE_CLIENTS client threads, and a HotEmbeddingCache against the
    engine; rows/s and p50 / p99 / max ms a request, over SERVE_TIMED
    requests one at a time (SERVE_FULL_TIMED of SERVE_BATCH rows), the
    test split's rows taken in turn and cycled."""
    import threading

    from repro_torch.models import ctr
    from repro_torch.serve import (HotEmbeddingCache, MicroBatcher,
                                   ServingEngine, id_frequencies)

    eng = ServingEngine.from_training(bundle, params, state, cfg,
                                      batch_size=SERVE_BATCH)
    n_max = max(SERVE_SIZES)
    check(len(te) >= n_max, f"{len(te)} test rows < {n_max}")
    ids, dense = te.ids[:n_max], te.dense[:n_max]
    with torch.inference_mode():
        ref = ctr.apply(eng.params, cfg, torch.as_tensor(ids, device="cuda"),
                        torch.as_tensor(dense, device="cuda")).cpu().numpy()
    errs = {}
    for n in SERVE_SIZES:
        got = eng.score(ids[:n], dense[:n])
        check(got.shape == (n,) and np.isfinite(got).all(),
              f"serving {n} rows: bad scores")
        errs[n] = float(np.abs(got - ref[:n]).max())
    print(f"[serve] deepfm-criteo fused snapshot after {GRAPH_STEPS} steps, "
          f"batch_size {SERVE_BATCH}: max |score - eager forward| by "
          f"request rows {errs} (bar 1e-5); captures {eng.n_traces}",
          flush=True)
    check(max(errs.values()) <= 1e-5 and eng.n_traces == 1,
          "the serving engine disagrees with the forward, or recaptured")

    # the test split tiled, so that a request's rows are a contiguous view
    # made before the clock starts
    reps = -(-max(100 * SERVE_TIMED, SERVE_BATCH * SERVE_FULL_TIMED)
             // len(te))
    ids_all = np.concatenate([te.ids] * reps)
    dense_all = np.concatenate([te.dense] * reps)

    def latencies(score, rows, count):
        lat = []
        t0 = time.perf_counter()
        for i in range(count):
            a = time.perf_counter()
            score(ids_all[i * rows:(i + 1) * rows],
                  dense_all[i * rows:(i + 1) * rows])
            lat.append(time.perf_counter() - a)
        return lat, time.perf_counter() - t0

    def report(what, lat, seconds, rows):
        ms = np.asarray(lat) * 1e3
        print(f"[serve] {what}: {rows / seconds:.0f} rows/s, p50 "
              f"{np.percentile(ms, 50):.3f} ms, p99 {np.percentile(ms, 99):.3f}"
              f" ms, max {ms.max():.3f} ms a request ({len(lat)} requests),"
              f" {kind} at {power}", flush=True)

    lat, sec = latencies(eng.score, 100, SERVE_TIMED)
    report("engine, 100-row requests one at a time", lat, sec,
           100 * SERVE_TIMED)
    lat, sec = latencies(eng.score, SERVE_BATCH, SERVE_FULL_TIMED)
    report(f"engine, {SERVE_BATCH}-row requests one at a time", lat, sec,
           SERVE_BATCH * SERVE_FULL_TIMED)

    gen = np.random.default_rng(0)
    sizes = gen.integers(1, 512, (SERVE_CLIENTS, SERVE_REQUESTS))
    starts = gen.integers(0, n_max - 512, (SERVE_CLIENTS, SERVE_REQUESTS))
    results, lat = {}, []
    lock = threading.Lock()
    with MicroBatcher(eng.score, max_batch=SERVE_BATCH,
                      max_wait_ms=2.0) as mb:
        barrier = threading.Barrier(SERVE_CLIENTS)

        def client(c):
            barrier.wait()
            for j in range(SERVE_REQUESTS):
                a, n = int(starts[c, j]), int(sizes[c, j])
                t = time.perf_counter()
                out = mb.score(ids[a:a + n], dense[a:a + n])
                with lock:
                    lat.append(time.perf_counter() - t)
                    results.setdefault((c, j), []).append(out)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        sec = time.perf_counter() - t0
        stats = mb.stats()
    once = all(len(results.get((c, j), [])) == 1
               for c in range(SERVE_CLIENTS) for j in range(SERVE_REQUESTS))
    err = max(float(np.abs(results[c, j][0] - ref[starts[c, j]:starts[c, j]
                                                  + sizes[c, j]]).max())
              for (c, j) in results)
    print(f"[serve] micro-batcher, {SERVE_CLIENTS} client threads x "
          f"{SERVE_REQUESTS} requests of 1-511 rows: every request answered "
          f"{'once' if once else 'NOT once'}, max |score - eager forward| "
          f"{err:.3e}; {stats['dispatches']} dispatches, mean fill "
          f"{stats['mean_fill']:.1f} rows", flush=True)
    check(once and len(results) == SERVE_CLIENTS * SERVE_REQUESTS
          and err <= 1e-5, "the micro-batcher lost, repeated or changed a "
          "request")
    report("micro-batcher", lat, sec, int(sizes.sum()))

    freqs = id_frequencies(tr.ids, cfg.vocab_sizes)
    cache = HotEmbeddingCache(cfg, eng.params, freqs, capacity=HOT_CAPACITY,
                              batch_size=SERVE_BATCH)
    got = cache.score(ids, dense)
    want = eng.score(ids, dense)
    err = float(np.abs(got - want).max())
    print(f"[serve] hot-id cache, {HOT_CAPACITY} rows a field on the card "
          f"({cache.stats()['device_rows']} of {cache.stats()['host_rows']})"
          f": max |cached - engine| over {n_max} rows {err:.3e} (bar 1e-5), "
          f"hit rate {cache.hit_rate():.4f}, captures {cache.n_traces}",
          flush=True)
    check(err <= 1e-5 and cache.n_traces == 1,
          "the hot-id cache disagrees with the engine, or recaptured")
    lat, sec = latencies(cache.score, 100, SERVE_TIMED)
    report("hot-id cache, 100-row requests one at a time", lat, sec,
           100 * SERVE_TIMED)
    del eng, cache, ids_all, dense_all


def embed_bound(n, dims, rows):
    """Least time for one embedding backward call over ``n`` keys and a
    group of ``n`` cotangent rows of each D in ``dims`` into ``[rows, D]``
    gradients: the keys and each cotangent read once, each whole gradient
    written once (its zero fill included); one add per cotangent element.
    Returns (ms, by, bytes)."""
    nbytes = n * 4 + sum(n * d * 4 + rows * d * 4 for d in dims)
    return (*_bound(nbytes, n * sum(dims)), nbytes)


def embed_phase(smi, kind):
    """Phase 24: the embedding backward against its plain version, bitwise
    (the max abs error printed), on one Zipf batch's 26 deepfm-criteo
    fields at 131,072 rows: the fm (D = 10) and LR (D = 1) groups in one
    call, as the fused step's lookup makes it, run twice (bitwise) and
    against a single call a group (bitwise); 3 groups; D = 17 and 64; a
    field of one id; ids past their tables (dropped); the sparse step's
    slot rows in the plan its dedups give (equal to the stable sort of
    the slot keys) and in an overflowing one. Times (L2 flushed, host
    work covered) of the step's one call (the sort, the zero fill and the
    levels over both groups) beside the combined byte bound, the parent's
    form (a call with its own sort for each lookup), the call on a plan
    (the sparse step's form), the sort and the fill alone, the plain
    version and PyTorch's ``embedding_dense_backward`` on the same inputs
    (both groups' columns side by side). Returns its JSON line."""
    from repro_torch.configs.deepfm_criteo import CRITEO_VOCABS
    from repro_torch.data import iterate_batches
    from repro_torch.kernels.embedding import (embedding_backward,
                                               embedding_backward_groups,
                                               field_layout, ref,
                                               reference_groups, sort_plan)
    from repro_torch.models.embedding import batch_unique, slot_plan

    power = smi.strip().split(", ")[-1]
    gen = torch.Generator(device="cuda").manual_seed(24)
    tr, _ = criteo_data()
    ids = torch.as_tensor(next(iterate_batches(tr, BATCH, seed=0))["ids"],
                          device="cuda")
    del tr
    dev = torch.device("cuda")
    layout = field_layout(tuple(CRITEO_VOCABS), dev)
    keys, rows = layout.keys(ids), layout.rows
    n = keys.numel()
    err = [0.0]

    def cotangents(dims):
        return [1e-3 * torch.randn(n, d, generator=gen, device="cuda")
                for d in dims]

    def case(tag, plan, rows, dims, twice=False, single_keys=None):
        cots = cotangents(dims)
        got = embedding_backward_groups(plan, cots, rows)
        want = reference_groups(plan, cots, rows)
        torch.cuda.synchronize()
        for d, a, b in zip(dims, got, want):
            what = f"{tag}, D = {d} ({n} rows into [{rows}, {d}])"
            same = torch.equal(a, b)
            compare("embed-kernel", f"{what}; bitwise "
                    f"{'equal' if same else 'different'}", a, b, err)
            check(same, f"the embedding backward is not bitwise its plain "
                  f"version: {what}")
        if twice:
            again = embedding_backward_groups(plan, cots, rows)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"[embed-kernel] {tag}, run twice: "
                  f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
            check(same, f"the embedding backward differs run to run: {tag}")
        if single_keys is not None:
            alone = [embedding_backward(single_keys, c, rows) for c in cots]
            same = all(torch.equal(a, b) for a, b in zip(got, alone))
            print(f"[embed-kernel] {tag}: one call over {len(dims)} groups "
                  f"against a call a group: "
                  f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
            check(same, f"the grouped call differs from a call a group: {tag}")
        del got, want, cots

    batch_plan = sort_plan(keys)
    case("one batch's 26 fields, fm and LR in one call", batch_plan, rows,
         (10, 1), twice=True, single_keys=keys)
    case("one batch's 26 fields, 3 groups", batch_plan, rows, (10, 1, 16),
         single_keys=keys)
    for dim in (17, 64):
        case("one batch's 26 fields, one group", batch_plan, rows, (dim,))
        torch.cuda.empty_cache()
    one = torch.zeros(n, dtype=torch.int32, device="cuda")
    case("a field of one id", sort_plan(one), 1, (10, 1), twice=True)
    past = ids.clone()
    past[::5] = layout.vocab_t.to(past.dtype)          # id V_f: dropped
    past[1::7] += layout.vocab_t.to(past.dtype)
    dropped = layout.keys(past)
    case(f"ids past their tables ({int((dropped == rows).sum())} dropped)",
         sort_plan(dropped), rows, (10, 1))
    for cap in (0, 4096):
        uniq = batch_unique(ids, CRITEO_VOCABS, cap)
        fields = [uniq[f"field_{i}"] for i in range(len(CRITEO_VOCABS))]
        slots = field_layout(tuple(u.capacity for u in fields), dev)
        plan = slot_plan(fields, slots)
        inv = torch.stack([u.inv for u in fields], dim=1)
        over = int((plan.keys == slots.rows).sum())
        if not cap:
            k_sorted, perm = torch.sort(slots.keys(inv), stable=True)
            same = torch.equal(plan.keys, k_sorted) and torch.equal(
                plan.perm, perm)
            print(f"[embed-kernel] the sparse step's plan from its 26 "
                  f"dedups against torch.sort(stable=True) of the slot "
                  f"keys: {'equal' if same else 'DIFFERENT'}", flush=True)
            check(same, "the sparse step's plan is not the stable sort")
            del k_sorted, perm
        case(f"the sparse step's slot rows, capacity "
             f"{cap or 'min(batch, vocab)'} ({over} dropped)", plan,
             slots.rows, (10, 1))
        del uniq, fields, plan, inv
    del past, dropped, one, batch_plan
    torch.cuda.empty_cache()

    scratch = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    c10, c1 = cotangents((10, 1))
    plan = sort_plan(keys)
    both = torch.cat([c10, c1], dim=1)
    fill = 64 * (-(-rows * 10 // 64) - (-rows // 64))
    runs = {
        "the step's one call (sort, fill, levels; fm and LR)":
            (lambda: embedding_backward_groups(sort_plan(keys), [c10, c1],
                                               rows), 20),
        "the parent's form: a call a lookup, each with its sort":
            (lambda: (embedding_backward(keys, c10, rows),
                      embedding_backward(keys, c1, rows)), 20),
        "one call on a plan (fill, levels: the sparse step's form)":
            (lambda: embedding_backward_groups(plan, [c10, c1], rows), 20),
        "the sort alone": (lambda: sort_plan(keys), 20),
        "the zero fill alone": (lambda: torch.zeros(fill, device="cuda"), 20),
        "plain version": (lambda: reference_groups(sort_plan(keys), [c10, c1],
                                                   rows), 3),
        "PyTorch's embedding_dense_backward, [N, 11]":
            (lambda: torch.ops.aten.embedding_dense_backward(
                both, keys, rows, -1, False), 20),
    }
    times = {name: cuda_time_cold_ms(fn, iters, scratch)
             for name, (fn, iters) in runs.items()}
    b_ms, b_by, nbytes = embed_bound(n, (10, 1), rows)
    for name, ms in times.items():
        print(f"[time] embedding backward, one batch's 26 fields ({n} rows "
              f"into [{rows}, 10] and [{rows}, 1]; L2 flushed, host work "
              f"covered), {name}: {ms:.4f} ms", flush=True)
    k_ms = times["the step's one call (sort, fill, levels; fm and LR)"]
    print(f"[time] embedding backward, the step's one call {k_ms:.4f} ms "
          f"against the bound {b_ms:.4f} ms by {b_by} ({nbytes} B at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s: {100 * b_ms / k_ms:.1f}% of it), "
          f"{ref.levels(n)} level launches; {kind} at {power}", flush=True)
    del scratch, keys, c10, c1, both, plan
    torch.cuda.empty_cache()
    return {
        "name": "embedding_backward",
        "route": "cuda",
        "source": "src/repro_torch/kernels/embedding/csrc/"
                  "embedding_backward.cu",
        # no TPU kernel: the JAX lookup whose gradient XLA computes
        "replaces": "src/repro/models/embedding.py:61",
        "launches": MAIN_PATH_LAUNCHES["embedding_backward"],
        "max_abs_err": err[0],
        "ms": k_ms,
        "plain_ms": times["plain version"],
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": times["PyTorch's embedding_dense_backward, [N, 11]"],
    }


def substrate_phase(tr, te, hp, power, kind):
    """Phase 25: the substrate placement at deepfm-criteo width and batch
    BATCH, SUBSTRATE_STEPS steps from phase 19's params over its batches
    through train_ctr's eager engine, counting the embedding backward's
    runs (its main path), and through the scan engine: scan == eager
    bitwise (params, state, losses); one replay traced (0 host
    reads, the embedding backward's launches a step, none of PyTorch's);
    the steady ms/step over SUBSTRATE_CHUNKS chunks each way; the eval's
    AUC by ``metrics.auc`` on the card against ``auc_numpy``. Before
    that, substrate and fused step by step in lockstep: every param after
    the first step within rtol 1e-5 / atol 1e-8 (the bar of the JAX
    package's ``test_fused_train_step_matches_substrate``, one step: the
    two update orders round differently, and Adam turns a near-zero
    gradient's rounding into a step of up to lr, which training then
    carries), the rows no batch has touched bitwise after every step, the
    gaps of the later steps printed."""
    from repro_torch.configs.deepfm_criteo import CONFIG
    from repro_torch.core.tree import flatten_with_paths, tree_map
    from repro_torch.data import iterate_batches
    from repro_torch.data.prefetch import chunk_epoch
    from repro_torch.embed import store_for
    from repro_torch.kernels.embedding import (embedding_backward_groups,
                                               ref, sort_plan)
    from repro_torch.models import ctr
    from repro_torch.serve import engine as serve_engine
    from repro_torch.train import engine as engine_lib
    from repro_torch.train import metrics, train_ctr

    tag = "substrate"
    params0 = ctr.init(CONFIG, seed=7, device="cuda")

    def run(placement, engine):
        cfg = dataclasses.replace(CONFIG, placement=placement, emb_sigma=1e-2)
        bundle = store_for(cfg).make_bundle(
            cfg, hp, warmup_steps=max(1, len(tr) // BATCH))
        params = tree_map(torch.clone, params0)
        res = train_ctr(cfg, None, tr, None, batch_size=BATCH, seed=3,
                        step_bundle=bundle, max_steps=SUBSTRATE_STEPS,
                        engine=engine, scan_steps=SCAN_STEPS,
                        init_state=(params, bundle.init(params)),
                        device="cuda")
        check(res.steps == SUBSTRATE_STEPS, f"{placement} {engine}: "
              f"{res.steps} steps")
        return cfg, bundle, res

    # substrate and fused in lockstep over the same batches: every param
    # after each step; the bar after the first (the JAX package's own
    # comparison is one step); later steps' gaps printed
    bundles = {p: store_for(c).make_bundle(
        c, hp, warmup_steps=max(1, len(tr) // BATCH)) for p, c in (
        (p, dataclasses.replace(CONFIG, placement=p, emb_sigma=1e-2))
        for p in ("substrate", "fused"))}
    live = {}
    for p, b in bundles.items():
        prm = tree_map(torch.clone, params0)
        live[p] = (prm, b.init(prm))
    touched = [torch.zeros(v, dtype=torch.bool, device="cuda")
               for v in CONFIG.vocab_sizes]
    gaps = []
    for i, hb in enumerate(iterate_batches(tr, BATCH, seed=3)):
        if i == SUBSTRATE_STEPS:
            break
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in hb.items()}
        for f, t in enumerate(touched):
            t[batch["ids"][:, f].to(torch.int64)] = True
        for p, b in bundles.items():
            live[p] = b.step(*live[p], batch)[:2]
        sub = flatten_with_paths(live["substrate"][0])
        fus = flatten_with_paths(live["fused"][0])
        worst, used, absent_rows, absent_ok = 0.0, 0.0, 0, True
        for k, x in sub.items():
            y = fus[k]
            err = (x - y).abs()
            worst = max(worst, float(err.max()))
            used = max(used, float((err / (1e-8 + 1e-5 * y.abs())).max()))
            if k.startswith("embed/"):
                absent = ~touched[int(k.rsplit("_", 1)[1])]
                absent_rows += int(absent.sum())
                absent_ok &= torch.equal(x[absent], y[absent])
        gaps.append((worst, used, absent_rows, absent_ok))
        print(f"[{tag}] substrate against fused after step {i + 1} from the "
              f"same params: max_abs {worst:.3e}, worst |err|/(atol + "
              f"rtol*|fused|) {used:.3f} (rtol 1e-5, atol 1e-8); "
              f"{absent_rows} embedding rows no batch touched yet: "
              f"{'bitwise equal' if absent_ok else 'DIFFER'}", flush=True)
        del sub, fus, batch
    check(gaps[0][1] <= 1.0, "substrate and fused disagree after a step at "
          "full width")
    check(all(g[3] and g[2] > 0 for g in gaps),
          "substrate and fused differ on the untouched rows")
    del live, bundles, touched
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    embedding_backward_groups.launches = sort_plan.sorts = 0
    cfg, bundle, eager = run("substrate", "eager")
    torch.cuda.synchronize()
    runs, sorts = embedding_backward_groups.launches, sort_plan.sorts
    peak = torch.cuda.max_memory_allocated() / 2**30
    scan = run("substrate", "scan")[2]
    diff = tree_diff((eager.params, eager.opt_state),
                     (scan.params, scan.opt_state))
    print(f"[{tag}] deepfm-criteo substrate, batch {BATCH}, "
          f"{SUBSTRATE_STEPS} steps eager: embedding backward runs {runs} "
          f"with {sorts} sorts (expected 1 a step each), losses "
          f"{[round(x, 6) for x in eager.losses]}, peak device memory "
          f"{peak:.2f} GiB; against the scan engine ({SCAN_STEPS} steps a "
          f"graph): params and state "
          f"{'bitwise equal' if not diff else f'DIFFER at {diff[:6]}'}, "
          f"losses {'bitwise equal' if eager.losses == scan.losses else 'DIFFER'}"
          f"; train_ctr's ms/step (CUDA events) eager "
          f"{[round(1e3 * x, 2) for x in eager.step_seconds]}, graph "
          f"(its capture included) "
          f"{[round(1e3 * x, 2) for x in scan.step_seconds]}", flush=True)
    check(runs == sorts == SUBSTRATE_STEPS,
          f"embedding backward ran {runs} times with {sorts} sorts on the "
          f"substrate path")
    check(not diff and eager.losses == scan.losses,
          "substrate: the graph replays differ from the eager steps")
    del scan
    torch.cuda.empty_cache()

    params, state = eager.params, eager.opt_state
    logits_fn = serve_engine.make_logits_fn(cfg)
    scores = serve_engine.padded_score_loop(logits_fn, params, te.ids,
                                            te.dense, 8192)
    on_card = float(metrics.auc(torch.as_tensor(scores, device="cuda"),
                                torch.as_tensor(te.labels, device="cuda")))
    host = metrics.auc_numpy(scores, te.labels)
    print(f"[{tag}] eval AUC over {len(te)} rows: metrics.auc on the card "
          f"{on_card:.9f}, auc_numpy {host:.9f} (|diff| "
          f"{abs(on_card - host):.2e}, bar 1e-6)", flush=True)
    check(abs(on_card - host) <= 1e-6, "metrics.auc disagrees with "
          "auc_numpy")

    chunk = {k: torch.as_tensor(v, device="cuda") for k, v in
             next(chunk_epoch(tr, BATCH, SCAN_STEPS, seed=4)).items()}
    runner = engine_lib.make_chunk_runner(bundle.step.scan_step)
    runner(params, state, chunk)          # the capture and a first replay
    torch.cuda.synchronize()
    wall_ms, prof = profiled(lambda: runner(params, state, chunk))
    kernels = by_kernel(prof)
    print_trace(tag, f"one replay of {SCAN_STEPS} steps", wall_ms, kernels,
                groups=(EMBED_GROUP,), steps=SCAN_STEPS)
    reads = sum(e.name == HOST_READ for e in prof.events())
    levels = sum(c for _, c, k in kernels if EMBED_KERNELS[0] in k)
    theirs = torch_embedding_backward(kernels)
    want_levels = ref.levels(BATCH * cfg.n_fields)
    print(f"[{tag}] one replay: {levels / SCAN_STEPS:g} embedding backward "
          f"level launches a step (expected {want_levels}: one run); "
          f"PyTorch's embedding backward "
          f"kernels {theirs}; host reads of a scalar {reads}", flush=True)
    check(reads == 0, f"substrate: {reads} host reads in a replay")
    check(levels == want_levels * SCAN_STEPS and not theirs,
          f"substrate: embedding backward kernels {levels}, PyTorch's "
          f"{theirs}")
    del prof
    eager_ms, graph_ms = steady_ms(bundle, runner, params, state, chunk,
                                   rounds=SUBSTRATE_CHUNKS)
    print(f"[{tag}] steady ms/step (CUDA events around each chunk of "
          f"{SCAN_STEPS} steps on batches already on the card, eager and "
          f"graph in turns): eager {spread(eager_ms)}, graph "
          f"{spread(graph_ms)}, {kind} at {power}", flush=True)
    check(all(math.isfinite(x) and x > 0 for x in eager_ms + graph_ms),
          "substrate: a steady chunk time is not positive")
    del runner, chunk, params, state, eager, params0
    gc.collect()
    torch.cuda.empty_cache()


def clip_phase():
    """Phase 26: the substrate with each Table-7 clip kind at phase 6's
    small size, 3 steps on the card against the same steps on the CPU
    (rtol 1e-5 / atol 1e-5)."""
    from repro_torch.core.cowclip import CLIP_KINDS
    from repro_torch.core.scaling import scale_hyperparams
    from repro_torch.data import make_ctr_dataset
    from repro_torch.models import ctr

    small = ctr.CTRConfig(name="deepfm", vocab_sizes=(2000, 700, 120, 30, 5),
                          n_dense=4, emb_dim=8, mlp_dims=(32, 32, 32),
                          emb_sigma=1e-2, placement="substrate")
    sds = make_ctr_dataset(3 * 512, small.vocab_sizes, n_dense=4, seed=1)
    shp = scale_hyperparams("cowclip", base_lr=1e-3, base_l2=1e-5,
                            base_batch=256, batch_size=512,
                            base_dense_lr=2e-3)
    params0 = ctr.init(small, seed=1, device="cpu")
    for clip in CLIP_KINDS:
        runs = {dev: run_small(small, shp, "substrate", dev, params0, sds,
                               clip_kind=clip, clip_t=0.5)
                for dev in ("cpu", "cuda")}
        worst = max((a - c).abs().max().item()
                    for a, c in zip(runs["cuda"], runs["cpu"]))
        agree = all(torch.allclose(a, c, rtol=1e-5, atol=1e-5)
                    for a, c in zip(runs["cuda"], runs["cpu"]))
        print(f"[clips] substrate, clip {clip!r}, 3 steps, card vs CPU: "
              f"max_abs {worst:.3e} (rtol 1e-5, atol 1e-5) "
              f"{'ok' if agree else 'FAIL'}", flush=True)
        check(agree, f"substrate with clip {clip}: card and CPU disagree")


# the hot/cold step's device time by kind of kernel: (label, name parts),
# a kernel counted under the first label one of whose parts it contains
HOT_KINDS = (
    ("the port's kernels", SPARSE_KERNELS + EMBED_KERNELS),
    ("GEMMs", ("gemm", "xmma")),
    ("top-C selection (topk)", ("topk", "Topk", "TopK")),
    ("sorts (the dedups)", ("RadixSort", "radix_sort", "Sort")),
    ("gathers (index ops)", ("gpu_index_kernel", "indexSelect",
                             "index_select")),
    ("write-backs (index_copy_)", ("index_copy",)),
    ("index_add_ (frequencies, counts)", ("indexFuncLargeIndex",)),
    ("cumsum compactions and scatters", ("Scan", "scan", "scatter")),
    ("copies", ("copy", "Copy")),
    ("elementwise and reductions", ("elementwise", "reduce", "Reduce")),
)


def print_kinds(prefix, kernels, steps):
    """A trace's device time by kind of kernel (``HOT_KINDS``, the rest
    last), ms a step and launches a step."""
    sums = {label: [0.0, 0] for label, _ in HOT_KINDS + (("other", ()),)}
    for ms_k, n, name in kernels:
        label = next((lb for lb, parts in HOT_KINDS
                      if any(x in name for x in parts)), "other")
        sums[label][0] += ms_k
        sums[label][1] += n
    print(f"[{prefix}] device time a step by kind: " + "; ".join(
        f"{label} {ms_k / steps:.3f} ms ({n / steps:g} launches)"
        for label, (ms_k, n) in sums.items()), flush=True)


def hot_stream(tr, bundle, engine, steps=HOT_STEPS, start=0):
    """Phases 27-29's and 31's batches: the train split replayed as an
    event stream (half a batch an event, seed 5), from step ``start``'s
    first row, re-batched on a worker thread into chunks of SCAN_STEPS
    (scan engine), of 1 (eager), or of 1 planned on the worker (the async
    cold store's transform, ``steps`` its budget)."""
    from repro_torch.data import stream as stream_lib

    events = stream_lib.synthetic_event_stream(
        tr, rows_per_event=BATCH // 2, seed=5)
    if start:
        events = stream_lib.skip_rows(events, start * BATCH)
    if bundle.stream_transform is not None:
        return stream_lib.stream_chunks(
            events, BATCH, 1, buffer_size=4,
            transform=bundle.stream_transform(max_steps=steps),
            start_rows=start * BATCH)
    return stream_lib.stream_chunks(
        events, BATCH, SCAN_STEPS if engine == "scan" else 1,
        start_rows=start * BATCH)


def hot_run(cfg, hp, tr, params0, engine, *, steps=HOT_STEPS,
            placement="hotcold", auxes=None, **store_kw):
    """``steps`` online steps through ``train_ctr(mode="stream")`` from
    ``params0`` over ``hot_stream``'s batches, then its flush. ``auxes``,
    when a list, gets each eager step's aux (kept on the card). Returns
    (bundle, result)."""
    from repro_torch.core.builders import StepFn
    from repro_torch.core.tree import tree_map
    from repro_torch.embed import store_for
    from repro_torch.train import train_ctr

    cfg = dataclasses.replace(cfg, placement=placement)
    bundle = store_for(cfg, **store_kw).make_bundle(
        cfg, hp, warmup_steps=max(1, len(tr) // BATCH))
    if auxes is not None:
        step = bundle.step

        def recorded(p, s, b):
            p, s, aux = step(p, s, b)
            auxes.append(aux)
            return p, s, aux

        bundle = bundle._replace(step=StepFn(recorded))
    params = bundle.prepare(tree_map(torch.clone, params0))
    res = train_ctr(cfg, None, tr, None, batch_size=BATCH,
                    step_bundle=bundle, max_steps=steps, engine=engine,
                    mode="stream", stream=hot_stream(tr, bundle, engine,
                                                     steps),
                    init_state=(params, bundle.init(params)), device="cuda")
    return bundle, res


def aux_sums(auxes):
    """Per-step hot/cold counters of recorded eager steps, read once:
    {name: [per step]}."""
    names = ("hot_hit_rows", "hot_lookup_rows", "evictions",
             "catchup_depth_max")
    rows = torch.stack([torch.stack([a[n].double() for n in names])
                        for a in auxes]).tolist()
    return {n: [r[i] for r in rows] for i, n in enumerate(names)}


def max_abs(a, b):
    """The largest absolute difference between two trees of tensors of
    one structure, on any devices."""
    from repro_torch.core.tree import flatten_with_paths

    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    check(fa.keys() == fb.keys(), "the trees differ in structure")
    return max(float((fa[k].double().cpu() - fb[k].double().cpu()).abs()
                     .max()) for k in fa)


def hotcold_phases(tr, hp, power, kind):
    """Phases 27-30: online training on the hot/cold tiers at
    deepfm-criteo width and batch BATCH from phase 19's initial params,
    synchronous (27: eager, eager again and graphs bitwise; against the
    sparse placement; launches a step; a traced replay; the steady state),
    at two capacities (28), with the async host cold store (29), and at
    phase 6's small size against the CPU (30). Returns the wrappers' calls
    on phase 27's eager run, for the kernels' JSON line."""
    from repro_torch.configs.deepfm_criteo import CONFIG
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.prefetch import chunk_epoch
    from repro_torch.embed.hotcold import hot_tier_bytes, residency_map_bytes
    from repro_torch.kernels import cowclip as cc
    from repro_torch.kernels.embedding import (embedding_backward_groups,
                                               ref, sort_plan)
    from repro_torch.models import ctr
    from repro_torch.train import engine as engine_lib

    # -- 27. sync hot/cold stream, full width ---------------------------
    phase_start(27)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(CONFIG, emb_sigma=1e-2)
    params0 = ctr.init(cfg, seed=7, device="cuda")
    wrappers = {"fused_cowclip_adam": cc.fused_cowclip_adam,
                "sparse_gather_catchup (one table)":
                    cc.sparse_gather_catchup,
                "sparse_update_scatter (one table)":
                    cc.sparse_update_scatter,
                "sparse_gather_catchup": cc.sparse_gather_catchup_tables,
                "sparse_update_scatter": cc.sparse_update_scatter_tables,
                "embedding_backward": embedding_backward_groups}
    for w in wrappers.values():
        w.launches = 0
    sort_plan.sorts = 0
    torch.cuda.reset_peak_memory_stats()
    auxes = []
    b_eager, eager = hot_run(cfg, hp, tr, params0, "eager",
                             hot_capacity=HOT_CAP, auxes=auxes)
    calls = {name: w.launches for name, w in wrappers.items()}
    sorts = sort_plan.sorts
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = {"sparse_gather_catchup": 1, "sparse_update_scatter": 1,
                "embedding_backward": 1}
    print(f"[hotcold] deepfm-criteo hotcold, capacity {HOT_CAP} a field, "
          f"cumulative admission, batch {BATCH}, {HOT_STEPS} steps of "
          f"train_ctr(mode='stream'), eager: wrapper calls {calls} "
          f"(expected a step: one of each grouped sparse kernel, one "
          f"embedding backward run, nothing else), the embedding backward's "
          f"sorts {sorts} (expected 0)", flush=True)
    check(all(calls[n] == HOT_STEPS * per_step.get(n, 0) for n in calls)
          and sorts == 0, f"hotcold launches {calls}, sorts {sorts}")
    sums = aux_sums(auxes)
    del auxes
    leaves = lambda r: (r.params, r.opt_state)  # noqa: E731
    again = hot_run(cfg, hp, tr, params0, "eager", hot_capacity=HOT_CAP)[1]
    runs_differ = tree_diff(leaves(eager), leaves(again))
    same_losses = eager.losses == again.losses
    del again
    b_scan, scan = hot_run(cfg, hp, tr, params0, "scan",
                           hot_capacity=HOT_CAP)
    graph_differ = tree_diff(leaves(eager), leaves(scan))
    print(f"[hotcold] eager against eager: "
          f"{'bitwise equal' if not runs_differ else f'DIFFER at {runs_differ[:6]}'}"
          f", losses {'equal' if same_losses else 'DIFFER'}; eager against "
          f"the scan engine ({SCAN_STEPS} steps a graph): params, moments, "
          f"last_step, hot tier, slot maps and frequencies "
          f"{'bitwise equal' if not graph_differ else f'DIFFER at {graph_differ[:6]}'}"
          f", losses "
          f"{'bitwise equal' if eager.losses == scan.losses else 'DIFFER'} "
          f"(last {scan.losses[-1]:.6f})", flush=True)
    check(not runs_differ and same_losses, "hotcold: two eager runs differ")
    check(not graph_differ and eager.losses == scan.losses,
          "hotcold: the graph replays differ from the eager steps")
    sparse = hot_run(cfg, hp, tr, params0, "eager", placement="sparse")[1]
    worst = max_abs(eager.params, sparse.params)
    bitwise = not tree_diff(eager.params, sparse.params)
    print(f"[hotcold] flushed hotcold against the flushed sparse placement "
          f"over the same batches: max_abs {worst:.3e} (bar 1e-7), "
          f"{'bitwise equal' if bitwise else 'not bitwise'}", flush=True)
    check(worst <= 1e-7, f"hotcold against sparse: max_abs {worst}")
    del sparse
    eager_ms = 1e3 * sum(eager.step_seconds[1:]) / (HOT_STEPS - 1)
    graph_ms = 1e3 * sum(scan.step_seconds[SCAN_STEPS:]) / (
        HOT_STEPS - SCAN_STEPS)
    hits, looks = sum(sums["hot_hit_rows"]), sum(sums["hot_lookup_rows"])
    state = scan.opt_state
    table_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(
        (scan.params["embed"], state["m"], state["v"], state["last_step"])))
    print(f"[hotcold] train_ctr's ms/step (CUDA events): eager "
          f"{eager_ms:.2f} (steps 2-{HOT_STEPS}), graph {graph_ms:.2f} (its "
          f"second chunk); hit rate {hits / looks:.4f} ({hits:.0f} of "
          f"{looks:.0f} looked-up rows; a step: "
          f"{[round(h / n, 4) for h, n in zip(sums['hot_hit_rows'], sums['hot_lookup_rows'])]}"
          f"), evictions a step {[int(e) for e in sums['evictions']]}, "
          f"catchup_depth_max a step "
          f"{[int(d) for d in sums['catchup_depth_max']]}; hot_tier_bytes "
          f"{hot_tier_bytes(state)}, residency_map_bytes "
          f"{residency_map_bytes(state)}, cold tables (w, m, v, last_step) "
          f"{table_bytes} B; peak device memory of the eager run "
          f"{peak_gb:.2f} GB; {kind} at {power}", flush=True)
    del eager, b_eager
    torch.cuda.empty_cache()

    chunk = {k: torch.as_tensor(v, device="cuda") for k, v in
             next(chunk_epoch(tr, BATCH, SCAN_STEPS, seed=4)).items()}
    params, state = scan.params, scan.opt_state
    del scan
    runner = engine_lib.make_chunk_runner(b_scan.step.scan_step)
    runner(params, state, chunk)          # the capture and a first replay
    torch.cuda.synchronize()
    wall_ms, prof = profiled(lambda: runner(params, state, chunk))
    kernels = by_kernel(prof)
    print_trace("hotcold", f"one replay of {SCAN_STEPS} steps", wall_ms,
                kernels, groups=(("the sparse kernels", SPARSE_KERNELS),
                                 EMBED_GROUP), steps=SCAN_STEPS)
    print_kinds("hotcold", kernels, SCAN_STEPS)
    counts = {n: sum(c for _, c, k in kernels if n in k)
              for n in FUSED_KERNELS + SPARSE_KERNELS + EMBED_KERNELS}
    theirs = torch_embedding_backward(kernels)
    reads = sum(e.name == HOST_READ for e in prof.events())
    levels = ref.levels(BATCH * cfg.n_fields)
    print(f"[hotcold] kernels of one replay: {counts} (a step: one of each "
          f"sparse kernel, the embedding backward's {levels} level "
          f"launches); PyTorch's embedding backward kernels {theirs}; host "
          f"reads of a scalar in the replay {reads}", flush=True)
    check(reads == 0, f"hotcold: {reads} host reads in a replay")
    check(not theirs, f"hotcold: PyTorch's embedding backward: {theirs}")
    check(counts["sparse_catchup_kernel"] == SCAN_STEPS
          and counts["sparse_update_kernel"] == SCAN_STEPS
          and sum(counts[n] for n in FUSED_KERNELS) == 0
          and counts[EMBED_KERNELS[0]] == levels * SCAN_STEPS,
          f"hotcold: kernels of a replay {counts}")
    del prof
    e_ms, g_ms = steady_ms(b_scan, runner, params, state, chunk,
                           rounds=HOT_TIMED)
    print(f"[hotcold] steady ms/step (CUDA events around each chunk of "
          f"{SCAN_STEPS} steps on batches already on the card, eager and "
          f"graph in turns): eager {spread(e_ms)}, graph {spread(g_ms)}, "
          f"{kind} at {power}", flush=True)
    check(all(math.isfinite(x) and x > 0 for x in e_ms + g_ms),
          "hotcold: a steady chunk time is not positive")
    del runner, chunk, params, state, b_scan
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[hotcold] phase 27 in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- 28. capacity independence, full width ---------------------------
    phase_start(28)
    t0 = time.perf_counter()
    ref_run = {}
    for cap in (HOT_CAP, HOT_CAP_BIG):
        auxes = []
        bundle, res = hot_run(cfg, hp, tr, params0, "eager",
                              hot_capacity=cap, auxes=auxes)
        s = aux_sums(auxes)
        ref_run[cap] = (res.params, sum(s["hot_hit_rows"])
                        / sum(s["hot_lookup_rows"]),
                        hot_tier_bytes(res.opt_state))
        del bundle, res, auxes
        torch.cuda.empty_cache()
    cap_differ = tree_diff(ref_run[HOT_CAP][0], ref_run[HOT_CAP_BIG][0])
    (_, rate_s, bytes_s), (_, rate_b, bytes_b) = (ref_run[HOT_CAP],
                                                  ref_run[HOT_CAP_BIG])
    print(f"[hotcold-capacity] capacities {HOT_CAP} and {HOT_CAP_BIG} over "
          f"phase 27's batches, flushed: params "
          f"{'bitwise equal' if not cap_differ else f'DIFFER at {cap_differ[:6]}'}"
          f"; hit rate {rate_s:.4f} and {rate_b:.4f}; hot_tier_bytes "
          f"{bytes_s} and {bytes_b}; in {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(not cap_differ, "hotcold: capacities give different params")
    check(rate_b >= rate_s, "hotcold: the hit rate fell with capacity")
    sync_params = ref_run[HOT_CAP][0]
    del ref_run
    torch.cuda.empty_cache()

    # -- 29. async cold store, full width ---------------------------------
    phase_start(29)
    t0 = time.perf_counter()
    bundle, res = hot_run(cfg, hp, tr, params0, "scan",
                          hot_capacity=HOT_CAP, cold_store="mem")
    ctrl = bundle.stream_driver.__self__
    st = ctrl.last_stream_stats
    exported = bundle.export(res.params)
    async_differ = tree_diff(exported, sync_params)
    n = st["steps"]
    print(f"[hotcold-async] --cold-store mem, capacity {HOT_CAP}, "
          f"{n} steps (phase 27's batches), the planner on the stream's worker, "
          f"chunks of 1, 4 deep: exported params against the synchronous "
          f"run's "
          f"{'bitwise equal' if not async_differ else f'DIFFER at {async_differ[:6]}'}"
          f"; plan {st['plan_seconds'] / n:.3f} s a step, the consumer's "
          f"stall {st['stall_seconds'] / n:.3f} s a step, overlap "
          f"{st['migration_overlap_fraction']:.3f}; plan bytes to the card "
          f"{st['plan_bytes_to_device'] // n} a step, eviction bytes back "
          f"{st['evict_bytes_from_device'] // n} a step, cold-store gather "
          f"{st['cold_gather_bytes'] // n} B a step; "
          f"{1e3 * res.seconds / n:.1f} ms a step (host clock, the whole "
          f"drive); hit rate "
          f"{st['hot_hit_rows'] / st['hot_lookup_rows']:.4f}; {kind} at "
          f"{power}", flush=True)
    check(n == HOT_STEPS, f"async: {n} steps")
    check(not async_differ, "async cold store differs from the sync step")
    del sync_params, exported
    # one more planned step, its dispatch on this thread traced
    from repro_torch.data import stream as stream_lib

    batch = next(stream_lib.batches_from_events(
        stream_lib.synthetic_event_stream(tr, rows_per_event=BATCH,
                                          seed=6), BATCH))
    # the planner's host time by function, over one more step
    import cProfile
    import pstats

    profile = cProfile.Profile()
    plan = profile.runcall(ctrl.planner.plan_batch, batch["ids"])
    rows = sorted(pstats.Stats(profile).stats.items(),
                  key=lambda kv: -kv[1][2])[:10]
    total = sum(v[2] for v in pstats.Stats(profile).stats.values())
    print(f"[hotcold-async] one more plan_batch under cProfile, "
          f"{total:.3f} s of its own time; the 10 largest (own s, calls, "
          f"function): " + "; ".join(
              f"{v[2]:.3f} x{v[1]} {k[2]} ({Path(k[0]).name}:{k[1]})"
              for k, v in rows), flush=True)
    chunk = {k: v[None] for k, v in batch.items()}
    _, prof = profiled(lambda: ctrl._dispatch(res.params["dense"],
                                              res.opt_state, plan, chunk))
    reads = sum(e.name == HOST_READ for e in prof.events())
    kernels = by_kernel(prof)
    print(f"[hotcold-async] one dispatch traced on the consumer's thread: "
          f"host reads of a scalar {reads}; the sparse kernels "
          f"{[(name, c) for _, c, name in kernels if any(s in name for s in SPARSE_KERNELS)]}",
          flush=True)
    check(reads == 0, f"async: {reads} host reads in a dispatch")
    plan.handle.rows("field_0")
    del prof, plan, ctrl, bundle, res
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[hotcold-async] phase 29 in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- 30. small-size agreement, card against CPU ----------------------
    phase_start(30)
    del params0
    t0 = time.perf_counter()
    hotcold_small_phase()
    print(f"[hotcold-agree] phase 30 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return calls


def hotcold_small_phase():
    """Phase 30 at phase 6's small size: the sync hot/cold step (capacity
    64, both admission policies) over 3 steps against the sparse
    placement on each device (max abs <= HOT_AGREE, the JAX package's
    bar) and card against CPU (phase 11's bar, residency exactly equal),
    beside the sparse placement's own card-against-CPU gap on the same
    batches; then the async mmap store flushed, closed, reopened and run
    on, against an uninterrupted run on the card, bitwise."""
    import tempfile

    from repro_torch.core.scaling import scale_hyperparams
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data import make_ctr_dataset
    from repro_torch.embed import store_for
    from repro_torch.embed.hotcold import resident_ids
    from repro_torch.models import ctr

    small = ctr.CTRConfig(name="deepfm", vocab_sizes=(2000, 700, 120, 30, 5),
                          n_dense=4, emb_dim=8, mlp_dims=(32, 32, 32),
                          emb_sigma=1e-2, placement="hotcold")
    sds = make_ctr_dataset(6 * 512, small.vocab_sizes, n_dense=4, seed=1)
    shp = scale_hyperparams("cowclip", base_lr=1e-3, base_l2=1e-3,
                            base_batch=256, batch_size=512,
                            base_dense_lr=2e-3)
    params0 = ctr.init(small, seed=1, device="cpu")

    def batch(i, dev):
        sl = slice(i * 512, (i + 1) * 512)
        return {"ids": torch.as_tensor(sds.ids[sl], device=dev),
                "dense": torch.as_tensor(sds.dense[sl], device=dev),
                "labels": torch.as_tensor(sds.labels[sl], device=dev)}

    def run(dev, steps, flush_at=(), path="hotcold", **kw):
        b = store_for(small, path=path, hot_capacity=64, **kw).make_bundle(
            small, shp, warmup_steps=2)
        p = b.prepare(tree_map(lambda t: t.clone().to(dev), params0))
        s = b.init(p)
        for i in steps:
            p, s, _ = b.step(p, s, batch(i, dev))
            if i in flush_at:
                p, s = b.flush(p, s)
        p, s = b.flush(p, s)
        return b, p, s

    devices = {"card": "cuda", "cpu": "cpu"}
    sparse = {k: run(dev, range(3), path="sparse")[1]
              for k, dev in devices.items()}
    sparse_gap = max_abs(sparse["card"], sparse["cpu"])
    for adm in ("cumulative", "decayed"):
        out = {k: run(dev, range(3), admission=adm, half_life=2)
               for k, dev in devices.items()}
        vs_sparse = {k: max_abs(out[k][1], sparse[k]) for k in out}
        worst = max_abs(out["card"][1], out["cpu"][1])
        agree = all(torch.allclose(a.cpu(), c, rtol=1e-5, atol=1e-5)
                    for a, c in zip(tree_leaves(out["card"][1]),
                                    tree_leaves(out["cpu"][1])))
        res_c = resident_ids(out["card"][2])
        res_h = resident_ids(out["cpu"][2])
        same_res = all(np.array_equal(np.sort(res_c[f]), np.sort(res_h[f]))
                       and torch.equal(out["card"][2]["hot"]["freq"][f].cpu(),
                                       out["cpu"][2]["hot"]["freq"][f])
                       for f in res_c)
        print(f"[hotcold-agree] 3 sync hot/cold steps + flush, {adm} "
              f"admission, capacity 64: against the sparse placement on "
              f"the card max_abs {vs_sparse['card']:.3e}, on the CPU "
              f"{vs_sparse['cpu']:.3e} (bar {HOT_AGREE:g}); card vs CPU "
              f"max_abs {worst:.3e} (rtol 1e-5, atol 1e-5; the sparse "
              f"placement's own card vs CPU on these batches "
              f"{sparse_gap:.3e}); resident ids and frequencies "
              f"{'equal' if same_res else 'DIFFER'}", flush=True)
        check(max(vs_sparse.values()) <= HOT_AGREE and agree and same_res,
              f"hotcold {adm}: card and CPU disagree")
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        b1, p1, _ = run("cuda", range(6), flush_at=(2,), cold_store="mmap",
                        cold_dir=d1)
        whole = [t.cpu() for t in tree_leaves(b1.export(p1))]
        b2, _, _ = run("cuda", range(3), cold_store="mmap", cold_dir=d2)
        b2.stream_driver.__self__.store.close()
        b3, p3, _ = run("cuda", range(3, 6), cold_store="mmap", cold_dir=d2)
        steps = b3.stream_driver.__self__.planner.t
        parts = [t.cpu() for t in tree_leaves(b3.export(p3))]
    same = all(torch.equal(a, b) for a, b in zip(whole, parts))
    print(f"[hotcold-agree] async mmap on the card: 3 steps, flush, close, "
          f"reopen, 3 more (the planner at step {steps}) against 6 "
          f"uninterrupted, flushed after step 3: "
          f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
    check(same and steps == 6, "async mmap: the reopened run differs")


def host_memory():
    """(MemAvailable bytes of the host, this process's peak RSS bytes)."""
    import resource

    avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    return avail, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def snap_dir():
    """A fresh directory for phase 31-32's snapshots under the checkout's
    build/ (gitignored); the caller removes it."""
    import tempfile

    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    return tempfile.mkdtemp(prefix="chip_smoke_snapshots_", dir=root)


def dur_run(cfg, hp, tr, params0, *, steps, guard=False, cb=None,
            init_state=None, start=0, bundle=None, eager=False):
    """``steps`` (total) online steps of the sync hot/cold placement at
    capacity HOT_CAP through ``train_ctr(mode="stream")``, from
    ``params0`` or ``init_state`` at step ``start``, over hot_stream's
    batches, with ``snapshot_cb=cb``; the scan engine unless ``eager``.
    Returns (bundle, result)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.embed import store_for
    from repro_torch.train import train_ctr

    cfg = dataclasses.replace(cfg, placement="hotcold")
    if bundle is None:
        bundle = store_for(cfg, hot_capacity=HOT_CAP).make_bundle(
            cfg, hp, warmup_steps=max(1, len(tr) // BATCH),
            nonfinite_guard=guard)
    if init_state is None:
        params = bundle.prepare(tree_map(torch.clone, params0))
        init_state = (params, bundle.init(params))
    engine = "eager" if eager else "scan"
    res = train_ctr(cfg, None, tr, None, batch_size=BATCH,
                    step_bundle=bundle, max_steps=steps, engine=engine,
                    mode="stream",
                    stream=hot_stream(tr, bundle, engine, steps, start),
                    init_state=init_state, start_step=start,
                    snapshot_cb=cb, device="cuda")
    return bundle, res


def state_of(res):
    return (res.params, res.opt_state)


def durability_phase(tr, hp, power, kind):
    """Phase 31 at deepfm-criteo width, batch BATCH, the sync hot/cold
    placement at capacity HOT_CAP, the scan engine with SCAN_STEPS steps
    a graph: the guard (guarded against unguarded over DUR_STEPS clean
    steps, bitwise; a poisoned batch inside a replayed chunk against the
    eager guarded steps, which leave every leaf bitwise unchanged; a
    traced guarded replay; the guard's ms a graph step beside the
    unguarded one, in turns), snapshots every SNAP_EVERY steps (each
    one's wall seconds by part, its bytes; the stream's ms a step with
    and without), the resume's seconds, and the resumed run against the
    uninterrupted one with the same cadence, bitwise. Returns the
    wrappers' calls on the eager guarded steps."""
    import shutil

    root = snap_dir()
    avail, rss = host_memory()
    print(f"[durability] at the start: host memory available {avail} B, "
          f"free space under {root} {shutil.disk_usage(root).free} B, "
          f"peak RSS so far {rss} B", flush=True)
    try:
        return _durability_phase(tr, hp, power, kind, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _durability_phase(tr, hp, power, kind, root):
    """Phase 31's body; its snapshots go under ``root``."""
    import shutil

    from repro_torch.configs.deepfm_criteo import CONFIG
    from repro_torch.core.tree import tree_map
    from repro_torch.data.prefetch import chunk_epoch
    from repro_torch.embed import store_for
    from repro_torch.kernels import cowclip as cc
    from repro_torch.kernels.embedding import embedding_backward_groups, ref
    from repro_torch.models import ctr
    from repro_torch.train import engine as engine_lib
    from repro_torch.train import snapshot as snap_lib

    cfg = dataclasses.replace(CONFIG, emb_sigma=1e-2)
    params0 = ctr.init(cfg, seed=7, device="cuda")
    leaves = state_of

    # -- the guard under the graph ----------------------------------------
    b_u, unguarded = dur_run(cfg, hp, tr, params0, steps=DUR_STEPS)
    b_g, guarded = dur_run(cfg, hp, tr, params0, steps=DUR_STEPS,
                           guard=True)
    differ = tree_diff(leaves(unguarded), leaves(guarded))
    skips = sum(1 for x in guarded.losses if not math.isfinite(x))
    print(f"[durability] guarded against unguarded sync hot/cold, "
          f"{DUR_STEPS} clean steps, {SCAN_STEPS} a graph: params, moments, "
          f"last_step, hot tier, slot maps, frequencies and the step "
          f"{'bitwise equal' if not differ else f'DIFFER at {differ[:6]}'}"
          f", losses "
          f"{'bitwise equal' if guarded.losses == unguarded.losses else 'DIFFER'}",
          flush=True)
    check(not differ and guarded.losses == unguarded.losses and skips == 0,
          "the guarded hot/cold step differs from the unguarded one on "
          "clean batches")
    chunk = next(chunk_epoch(tr, BATCH, SCAN_STEPS, seed=4))
    chunk["dense"][1, 0, 0] = np.nan
    chunk = {k: torch.as_tensor(v, device="cuda") for k, v in chunk.items()}
    wrappers = {"sparse_gather_catchup": cc.sparse_gather_catchup_tables,
                "sparse_update_scatter": cc.sparse_update_scatter_tables,
                "embedding_backward": embedding_backward_groups,
                "fused_cowclip_adam": cc.fused_cowclip_adam}
    for w in wrappers.values():
        w.launches = 0
    p, s = tree_map(torch.clone, leaves(guarded))
    skipped, unchanged = [], None
    for i in range(SCAN_STEPS):
        before = tree_map(torch.clone, (p, s)) if i == 1 else None
        p, s, aux = b_g.step(p, s, {k: v[i] for k, v in chunk.items()})
        skipped.append(aux["skipped_steps"])
        if before is not None:
            unchanged = tree_diff(before, (p, s))
            del before
    calls = {name: w.launches for name, w in wrappers.items()}
    skipped = [int(x) for x in skipped]
    eager = (p, s)
    p, s = tree_map(torch.clone, leaves(guarded))
    runner_g = engine_lib.make_chunk_runner(b_g.step.scan_step)
    p, s, aux = runner_g(p, s, chunk)
    replay_differ = tree_diff(eager, (p, s))
    n_skipped = int(aux["skipped_steps"].sum())
    print(f"[durability] a NaN batch 2nd of a chunk of {SCAN_STEPS}: eager "
          f"guarded steps skipped {skipped}, the poisoned step left every "
          f"leaf (params, moments, last_step, hot tier, slot maps, "
          f"frequencies, the step) "
          f"{'bitwise unchanged' if not unchanged else f'CHANGED at {unchanged[:6]}'}"
          f"; the graph's replay skipped {n_skipped}, the step "
          f"{int(s['step'])}, "
          f"{'bitwise equal to' if not replay_differ else 'DIFFERS from'} "
          f"the eager steps; wrapper calls of the {SCAN_STEPS} eager steps "
          f"{calls}", flush=True)
    check(skipped == [0, 1, 0, 0][:SCAN_STEPS] and not unchanged
          and n_skipped == 1 and not replay_differ
          and int(s["step"]) == DUR_STEPS + SCAN_STEPS - 1,
          f"the guard under a graph at full width ({replay_differ[:4]})")
    check(calls["sparse_gather_catchup"] == SCAN_STEPS
          and calls["sparse_update_scatter"] == SCAN_STEPS
          and calls["embedding_backward"] == SCAN_STEPS
          and calls["fused_cowclip_adam"] == 0,
          f"guarded hot/cold launches {calls}")
    del eager, aux
    # one more replay (the same chunk, poisoned), traced
    wall_ms, prof = profiled(lambda: runner_g(p, s, chunk))
    kernels = by_kernel(prof)
    counts = {n: sum(c for _, c, k in kernels if n in k)
              for n in FUSED_KERNELS + SPARSE_KERNELS + EMBED_KERNELS}
    reads = sum(e.name == HOST_READ for e in prof.events())
    theirs = torch_embedding_backward(kernels)
    levels = ref.levels(BATCH * cfg.n_fields)
    print(f"[durability] one guarded replay traced ({wall_ms:.1f} ms wall "
          f"for {SCAN_STEPS} steps): kernels {counts} (a step: one of each "
          f"sparse kernel and the embedding backward's {levels} level "
          f"launches, as unguarded); PyTorch's embedding backward kernels "
          f"{theirs}; host reads of a scalar {reads}", flush=True)
    check(reads == 0 and not theirs
          and counts["sparse_catchup_kernel"] == SCAN_STEPS
          and counts["sparse_update_kernel"] == SCAN_STEPS
          and sum(counts[n] for n in FUSED_KERNELS) == 0
          and counts[EMBED_KERNELS[0]] == levels * SCAN_STEPS,
          f"guarded replay: kernels {counts}, host reads {reads}")
    del prof
    clean = {k: torch.as_tensor(v, device="cuda") for k, v in
             next(chunk_epoch(tr, BATCH, SCAN_STEPS, seed=6)).items()}
    pu, su = leaves(unguarded)
    runner_u = engine_lib.make_chunk_runner(b_u.step.scan_step)
    runner_u(pu, su, clean)
    runner_g(p, s, clean)
    torch.cuda.synchronize()
    spans = {"unguarded": [], "guarded": []}
    for _ in range(DUR_TIMED):
        for name, fn in (("unguarded", lambda: runner_u(pu, su, clean)),
                         ("guarded", lambda: runner_g(p, s, clean))):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            spans[name].append((a, b))
    torch.cuda.synchronize()
    ms = {n: [a.elapsed_time(b) / SCAN_STEPS for a, b in v]
          for n, v in spans.items()}
    print(f"[durability] ms a graph step (CUDA events around each replay "
          f"of {SCAN_STEPS} steps, in turns): unguarded "
          f"{spread(ms['unguarded'])}, guarded {spread(ms['guarded'])}; "
          f"{kind} at {power}", flush=True)
    check(all(math.isfinite(x) and x > 0 for v in ms.values() for x in v),
          "guard timing")
    del runner_g, runner_u, p, s, pu, su, chunk, clean, b_g, guarded
    phase_end()

    # -- snapshots every SNAP_EVERY steps, and the resume -----------------
    avail, rss = host_memory()
    print(f"[durability] before the snapshots: host memory available "
          f"{avail} B, free space under {root} "
          f"{shutil.disk_usage(root).free} B, peak RSS so far {rss} B",
          flush=True)
    store = store_for(dataclasses.replace(cfg, placement="hotcold"),
                      hot_capacity=HOT_CAP)
    token = snap_lib.placement_token(store)
    mgr = snap_lib.SnapshotManager(root, retain=2)
    taken = []

    def cb(params, state, n):
        if n % SNAP_EVERY == 0:
            t0 = time.perf_counter()
            params, state = snap_lib.capture(
                mgr, b_s, params, state, step=n,
                cursor={"rows_consumed": n * BATCH},
                meta={"placement": token,
                      "snapshot_every": SNAP_EVERY})
            taken.append((n, time.perf_counter() - t0,
                          dict(mgr.last_timings)))
        return params, state

    b_s = store.make_bundle(dataclasses.replace(cfg, placement="hotcold"),
                            hp, warmup_steps=max(1, len(tr) // BATCH))
    _, snapped = dur_run(cfg, hp, tr, params0, steps=DUR_STEPS, cb=cb,
                         bundle=b_s)
    for n, wall, t in taken:
        print(f"[durability] snapshot at step {n}: {wall:.2f} s of "
              f"stall (flush {t['flush']:.2f}, export to host "
              f"{t['export']:.2f}, write with fsync {t['write']:.2f}, "
              f"sha256 {t['sha256']:.2f}, manifest with rename and "
              f"rotation {t['manifest']:.2f}), payload {t['bytes']} B",
              flush=True)
    check([n for n, _, _ in taken] == list(range(
        SNAP_EVERY, DUR_STEPS + 1, SNAP_EVERY)), f"snapshots {taken}")
    print(f"[durability] the stream's ms a step (host clock over "
          f"train_ctr's {DUR_STEPS} steps, the graphs' captures "
          f"included): with snapshots every {SNAP_EVERY} "
          f"{1e3 * snapped.seconds / DUR_STEPS:.1f}, without "
          f"{1e3 * unguarded.seconds / DUR_STEPS:.1f}; the steps alone "
          f"(CUDA events, second chunk) "
          f"{1e3 * np.mean(snapped.step_seconds[SCAN_STEPS:]):.2f} and "
          f"{1e3 * np.mean(unguarded.step_seconds[SCAN_STEPS:]):.2f}",
          flush=True)
    del unguarded, b_u
    phase_end()

    # the run killed after its step-SNAP_EVERY snapshot: resume from it
    shutil.rmtree(Path(root) / f"snap-{DUR_STEPS:08d}")
    b_r = store.make_bundle(dataclasses.replace(cfg, placement="hotcold"),
                            hp, warmup_steps=max(1, len(tr) // BATCH))
    t0 = time.perf_counter()
    restored = snap_lib.resume(mgr, b_r, ctr.init(cfg, seed=8,
                                                  device="cuda"),
                               token=token)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    check(restored is not None, "no valid snapshot to resume from")
    rp, rs, start, cursor = restored
    print(f"[durability] resumed from step {start} (cursor {cursor}) in "
          f"{resume_s:.2f} s (validate the checksums, load, overlay on "
          f"the card)", flush=True)
    check(start == SNAP_EVERY and int(rs["step"]) == SNAP_EVERY,
          f"resumed at {start}")
    # the uninterrupted run flushes at step DUR_STEPS (its snapshot)
    # and at the stream's end: the resumed run's end-of-stream flush
    # at DUR_STEPS is the same flush, so the cadence is the same
    _, resumed = dur_run(cfg, hp, tr, None, steps=DUR_STEPS,
                         init_state=(rp, rs), start=start, bundle=b_r)
    del rp, rs, restored
    differ = tree_diff(leaves(snapped), leaves(resumed))
    same_losses = snapped.losses[SNAP_EVERY:] == resumed.losses
    print(f"[durability] resumed at step {start}, run to {DUR_STEPS}, "
          f"against the uninterrupted run with the same cadence: params, "
          f"moments, last_step, hot tier, slot maps, frequencies and the "
          f"step "
          f"{'bitwise equal' if not differ else f'DIFFER at {differ[:6]}'}"
          f", losses of steps {start + 1}-{DUR_STEPS} "
          f"{'bitwise equal' if same_losses else 'DIFFER'}", flush=True)
    check(not differ and same_losses, "the resumed run differs")
    del snapped, resumed, b_s, b_r
    return calls


def small_setup(placement):
    """Phase 6's small size (the guard's and phase 30's): config,
    hyperparameters and a dataset."""
    from repro_torch.core.scaling import scale_hyperparams
    from repro_torch.data import make_ctr_dataset
    from repro_torch.models import ctr

    cfg = ctr.CTRConfig(name="deepfm", vocab_sizes=(2000, 700, 120, 30, 5),
                        n_dense=4, emb_dim=8, mlp_dims=(32, 32, 32),
                        emb_sigma=1e-2, sparse=placement == "sparse",
                        placement=placement)
    hp = scale_hyperparams("cowclip", base_lr=1e-3, base_l2=1e-3,
                           base_batch=256, batch_size=512,
                           base_dense_lr=2e-3)
    ds = make_ctr_dataset(16 * 512, cfg.vocab_sizes, n_dense=4, seed=1)
    return cfg, hp, ds


def durability_small_phase():
    """Phase 32 at phase 6's small size, on the card: the sparse
    placement killed with pending decay depth 2 and resumed; the async
    mem and mmap stores snapshotted and resumed in a fresh bundle; a
    fused snapshot resumed under sparse (params only, warned); the CLI
    killed inside its step-8 snapshot write by a FaultPlan in a child
    process, then --resume: each bitwise against its uninterrupted run;
    then the CLI's --nonfinite-guard on the sync hot/cold placement."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data import iterate_batches
    from repro_torch.data import stream as stream_lib
    from repro_torch.embed import EmbeddingStore, store_for
    from repro_torch.embed.store import max_pending_depth
    from repro_torch.launch import train as launch
    from repro_torch.models import ctr
    from repro_torch.testing import FaultPlan
    from repro_torch.train import snapshot as snap_lib
    from repro_torch.train import train_ctr

    root = snap_dir()
    try:
        # sparse, killed at pending depth 2, resumed
        cfg, hp, ds = small_setup("sparse")
        store = store_for(cfg)
        token = snap_lib.placement_token(store)
        params0 = ctr.init(cfg, seed=1, device="cuda")

        def run(d, *, max_steps, start=0, init_state=None, bundle=None,
                depth=None):
            bundle = bundle or store.make_bundle(cfg, hp, warmup_steps=2)
            mgr = snap_lib.SnapshotManager(d)
            last = [start]

            def cb(p, s, n):
                if depth is not None:
                    depth.append(max_pending_depth(s))
                if n - last[0] >= 4:
                    p, s = snap_lib.capture(mgr, bundle, p, s, step=n,
                                            cursor={"rows_consumed":
                                                    n * 512},
                                            meta={"placement": token})
                    last[0] = n
                return p, s

            if init_state is None:
                p = bundle.prepare(tree_map(torch.clone, params0))
                init_state = (p, bundle.init(p))
            events = stream_lib.synthetic_event_stream(ds, rows_per_event=256,
                                                       seed=1)
            if start:
                events = stream_lib.skip_rows(events, start * 512)
            res = train_ctr(cfg, None, ds, None, batch_size=512,
                            step_bundle=bundle, max_steps=max_steps,
                            engine="scan", mode="stream",
                            stream=stream_lib.stream_chunks(
                                events, 512, 2, start_rows=start * 512),
                            init_state=init_state, start_step=start,
                            snapshot_cb=cb, device="cuda")
            return bundle, res

        b_a, whole = run(os.path.join(root, "a"), max_steps=12)
        depth = []
        run(os.path.join(root, "b"), max_steps=6, depth=depth)
        b_b = store.make_bundle(cfg, hp, warmup_steps=2)
        p, s, start, _ = snap_lib.resume(
            snap_lib.SnapshotManager(os.path.join(root, "b")), b_b,
            ctr.init(cfg, seed=2, device="cuda"), token=token)
        _, resumed = run(os.path.join(root, "b"), max_steps=12, start=start,
                         init_state=(p, s), bundle=b_b)
        differ = tree_diff(state_of(whole), state_of(resumed))
        print(f"[durability-small] sparse: the run stopped at step 6 with "
              f"pending decay depth {depth[-1]}, resumed from step {start} "
              f"in a fresh bundle and run to 12, against 12 uninterrupted "
              f"steps with the same cadence (snapshots every 4, chunks of "
              f"2, graphs): "
              f"{'bitwise equal' if not differ else f'DIFFER at {differ[:6]}'}",
              flush=True)
        check(depth[-1] == 2 and start == 4 and not differ,
              "sparse resume differs")
        del b_a, whole, b_b, p, s, resumed

        # the async stores: a snapshot resumed in a fresh bundle
        hcfg, hp, ds = small_setup("hotcold")
        batches = [{k: torch.as_tensor(v, device="cuda")
                    for k, v in b.items()}
                   for _, b in zip(range(8), iterate_batches(ds, 512,
                                                             seed=2))]
        hparams0 = ctr.init(hcfg, seed=1, device="cuda")
        for backend in ("mem", "mmap"):
            def make(d):
                st = EmbeddingStore(placement="hotcold", hot_capacity=64,
                                    cold_store=backend, cold_dir=d)
                return st, st.make_bundle(hcfg, hp, warmup_steps=2)

            def steps(bundle, p, s, bs):
                for b in bs:
                    p, s, _ = bundle.step(p, s, b)
                return bundle.flush(p, s)

            st, bundle = make(os.path.join(root, f"{backend}_live"))
            p = bundle.prepare(tree_map(torch.clone, hparams0))
            s = bundle.init(p)
            p, s = steps(bundle, p, s, batches[:4])
            mgr = snap_lib.SnapshotManager(os.path.join(root,
                                                        f"{backend}_snaps"))
            p, s = snap_lib.capture(mgr, bundle, p, s, step=4,
                                    cursor={"rows_consumed": 4 * 512},
                                    meta={"placement":
                                          snap_lib.placement_token(st)})
            p, s = steps(bundle, p, s, batches[4:])
            want = [t.cpu() for t in tree_leaves(bundle.export(p))]
            st2, bundle2 = make(os.path.join(root, f"{backend}_resumed"))
            p2, s2, start, _ = snap_lib.resume(
                mgr, bundle2, tree_map(torch.clone, hparams0),
                token=snap_lib.placement_token(st2),
                cold_dir=os.path.join(root, f"{backend}_resumed"))
            p2, s2 = steps(bundle2, p2, s2, batches[4:])
            got = [t.cpu() for t in tree_leaves(bundle2.export(p2))]
            same = all(torch.equal(a, b) for a, b in zip(want, got))
            print(f"[durability-small] async {backend}: snapshot at step 4, "
                  f"resumed at step {start} in a fresh bundle, 4 more steps: "
                  f"{'bitwise equal' if same else 'DIFFER'} to the bundle "
                  f"that wrote it", flush=True)
            check(same and start == 4 and s2["step"] == 8,
                  f"async {backend} resume differs")
            # no view of a store outlives its close
            del p, s, p2, s2, want, got
            for b in (bundle, bundle2):
                snap_lib.controller_of(b).store.close()
            del st, bundle, st2, bundle2

        # a fused snapshot resumed under sparse: params only, warned
        fcfg, hp, ds = small_setup("fused")
        fstore = store_for(fcfg)
        fb = fstore.make_bundle(fcfg, hp, warmup_steps=2)
        p = fb.prepare(ctr.init(fcfg, seed=1, device="cuda"))
        s = fb.init(p)
        for b in batches[:2]:
            p, s, _ = fb.step(p, s, b)
        mgr = snap_lib.SnapshotManager(os.path.join(root, "fused"))
        p, s = snap_lib.capture(mgr, fb, p, s, step=2,
                                cursor={"rows_consumed": 1024},
                                meta={"placement":
                                      snap_lib.placement_token(fstore)})
        scfg, _, _ = small_setup("sparse")
        sb = store_for(scfg).make_bundle(scfg, hp, warmup_steps=2)
        warned = []
        sp, ss, start, _ = snap_lib.resume(
            mgr, sb, ctr.init(scfg, seed=3, device="cuda"),
            token="sparse:auto:none", warn=warned.append)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(fb.export(p)), tree_leaves(sb.export(sp))))
        fresh = int(ss["step"]) == 0 and all(
            int(t.abs().max()) == 0 for t in tree_leaves(ss["m"]))
        print(f"[durability-small] a fused snapshot resumed under sparse: "
              f"params {'bitwise equal' if same else 'DIFFER'}, optimizer "
              f"state {'fresh' if fresh else 'NOT FRESH'}; warned: "
              f"{warned[0][-90:] if warned else 'NOTHING'}", flush=True)
        check(same and fresh and warned and "params-only" in warned[0],
              "the cross-placement resume")
        del fb, sb, p, s, sp, ss

        # the CLI: killed inside its step-8 snapshot, then --resume
        src = Path(__file__).resolve().parent / "src"
        args = ["--task", "ctr", "--mode", "stream", "--steps", "12",
                "--samples", "4096", "--batch", "256", "--base-batch", "256",
                "--snapshot-every", "4", "--placement", "sparse", "--engine",
                "scan", "--scan-steps", "2"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            launch.main(args + ["--snapshot-dir", os.path.join(root, "ref"),
                                "--checkpoint",
                                os.path.join(root, "ref.npz")])
        plan = FaultPlan(kill_at_step=8, kill_in_snapshot=True)
        env = dict(os.environ)
        env["PYTHONPATH"] = str(src) + (os.pathsep + env["PYTHONPATH"]
                                        if env.get("PYTHONPATH") else "")
        env.update(plan.to_env())
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train"] + args
            + ["--snapshot-dir", os.path.join(root, "cli")], env=env,
            cwd=Path(__file__).resolve().parent, capture_output=True,
            text=True, timeout=600)
        child_s = time.perf_counter() - t0
        listing = sorted(os.listdir(os.path.join(root, "cli")))
        with contextlib.redirect_stdout(out):
            launch.main(args + ["--snapshot-dir", os.path.join(root, "cli"),
                                "--resume", "--checkpoint",
                                os.path.join(root, "resumed.npz")])
        with np.load(os.path.join(root, "ref.npz")) as a, \
                np.load(os.path.join(root, "resumed.npz")) as b:
            keys = [k for k in a.files if k.startswith("params/")]
            same = (keys and set(keys) == {k for k in b.files
                                           if k.startswith("params/")}
                    and all(np.array_equal(a[k], b[k]) for k in keys))
        resumed_at = [ln for ln in out.getvalue().splitlines()
                      if "resumed from snapshot step" in ln]
        print(f"[durability-small] the CLI on the card under "
              f"FaultPlan(kill_at_step=8, kill_in_snapshot=True): the child "
              f"exited {child.returncode} in {child_s:.1f} s leaving "
              f"{listing}; --resume: {resumed_at}; params "
              f"{'bitwise equal' if same else 'DIFFER'} to the uninterrupted "
              f"run's", flush=True)
        check(child.returncode == -9, "the child was not killed: "
              + child.stderr[-2000:])
        check("snap-00000008.tmp" in listing
              and "snap-00000008" not in listing, f"snapshots {listing}")
        check(resumed_at and "step 4" in resumed_at[0] and same,
              "the CLI's resumed run differs")

        # the CLI's guard on the sync hot/cold placement, on the card
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            launch.main(["--task", "ctr", "--mode", "stream", "--steps", "4",
                         "--samples", "4096", "--batch", "256",
                         "--base-batch", "256", "--placement", "hotcold",
                         "--hot-capacity", "64", "--scan-steps", "2",
                         "--nonfinite-guard"])
        done = [ln for ln in out.getvalue().splitlines()
                if ln.startswith("[train] done")]
        print(f"[durability-small] the CLI with --placement hotcold "
              f"--nonfinite-guard on the card: {done}", flush=True)
        check(done and "4 steps" in done[0], "the CLI's guarded hot/cold run")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def durability_phases(tr, hp, power, kind):
    """Phases 31-32; returns phase 31's wrapper calls on the eager
    guarded hot/cold steps, for the kernels' JSON line."""
    phase_start(31)
    t0 = time.perf_counter()
    calls = durability_phase(tr, hp, power, kind)
    phase_end()
    print(f"[durability] phase 31 in {time.perf_counter() - t0:.1f} s; "
          f"peak host RSS so far {host_memory()[1]} B", flush=True)
    phase_start(32)
    t0 = time.perf_counter()
    durability_small_phase()
    phase_end()
    print(f"[durability-small] phase 32 in {time.perf_counter() - t0:.1f} "
          f"s; peak host RSS so far {host_memory()[1]} B", flush=True)
    return calls

def shard_run(cfg, hp, tr, params0, engine, *, placement, grid=None,
              steps=SHARD_STEPS, batch=None, guard=False):
    """``steps`` steps of ``placement`` through ``train_ctr`` from
    ``params0`` over ``tr``'s batches of ``batch`` rows (default BATCH;
    seed 3, phases 19-20's), on the grid ``grid`` for a sharded placement,
    under the non-finite guard if ``guard``; the scan engine takes
    SCAN_STEPS steps a graph. Returns (bundle, result)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.embed import store_for
    from repro_torch.train import train_ctr

    batch = batch or BATCH

    cfg = dataclasses.replace(cfg, placement=placement,
                              sparse=placement == "sparse")
    bundle = store_for(cfg, mesh=grid).make_bundle(
        cfg, hp, warmup_steps=max(1, len(tr) // batch),
        nonfinite_guard=guard)
    params = bundle.prepare(tree_map(torch.clone, params0))
    res = train_ctr(cfg, None, tr, None, batch_size=batch, seed=3,
                    step_bundle=bundle, max_steps=steps, engine=engine,
                    scan_steps=SCAN_STEPS,
                    init_state=(params, bundle.init(params)), device="cuda")
    check(res.steps == steps, f"{placement} {engine}: {res.steps} steps")
    return bundle, res


def exported(bundle, res):
    """A run's flushed params as whole tables (``export``), flat."""
    from repro_torch.core.tree import flatten_with_paths

    params, _ = bundle.flush(res.params, res.opt_state)
    return flatten_with_paths(bundle.export(params))


def held_to(tag, got, want, rtol, atol):
    """Max abs difference of two flat param dicts and the share of the
    bar ``atol + rtol*|want|`` the worst element uses (<= 1 holds)."""
    worst, used = 0.0, 0.0
    for k, y in want.items():
        err = (got[k] - y).abs()
        worst = max(worst, float(err.max()))
        used = max(used, float((err / (atol + rtol * y.abs())).max()))
    return worst, used


def sharded_phase(placement, tr, hp, power, kind):
    """Phase 33 (``sharded``) or 34 (``sharded_sparse``) on an NCCL world
    of one rank (a 1x1 grid, every collective issued at size 1), at
    deepfm-criteo width and batch BATCH from phase 19's initial params:
    SHARD_STEPS steps eager (the wrappers' calls a step: 52 fused updates,
    or one launch of each sparse kernel; one embedding backward run with
    its one sort) and through the scan engine, bitwise equal; one step
    against the port's substrate (sharded) or flushed sparse placement
    (sharded_sparse) at phase 25's bar, rtol 1e-5 / atol 1e-8 (sharded
    also against fused, printed); sharded_sparse: the forward's inline
    decay against the catch-up kernel's rows, bitwise, and at phase 6's
    small size a capped capacity that overflows, in a replayed chunk,
    against the substrate and the eager steps; a traced replay (the
    update's launches, the embedding backward's, NCCL's kernels and their
    device time a step, 0 host reads); the steady ms/step each way. The
    process group is destroyed on the way out. Returns the wrappers'
    calls on the eager run."""
    from repro_torch.launch import mesh as mesh_lib

    with mesh_lib.process_group("cuda"):
        grid = mesh_lib.make_ctr_mesh(1, 1, device_type="cuda")
        calls = _sharded_phase(placement, grid, tr, hp, power, kind)
        del grid
        phase_end()
    return calls


def _sharded_phase(placement, grid, tr, hp, power, kind):
    from repro_torch.configs.deepfm_criteo import CONFIG
    from repro_torch.data.prefetch import chunk_epoch
    from repro_torch.kernels.embedding import ref, sort_plan
    from repro_torch.models import ctr
    from repro_torch.train import engine as engine_lib

    tag = f"{placement}-1x1"
    t0 = time.perf_counter()
    cfg = dataclasses.replace(CONFIG, emb_sigma=1e-2)
    params0 = ctr.init(cfg, seed=7, device="cuda")
    wrappers = shard_wrappers()
    sort_plan.sorts = 0
    b_eager, eager = shard_run(cfg, hp, tr, params0, "eager",
                               placement=placement, grid=grid)
    torch.cuda.synchronize()
    calls = {name: w.launches for name, w in wrappers.items()}
    sorts = sort_plan.sorts
    n_tables = 2 * cfg.n_fields
    per_step = ({"cowclip_adam_update": n_tables, "embedding_backward": 1}
                if placement == "sharded" else
                {"sparse_gather_catchup": 1, "sparse_update_scatter": 1,
                 "embedding_backward": 1})
    print(f"[{tag}] deepfm-criteo {placement} on an NCCL world of one rank "
          f"(div), batch {BATCH}, {SHARD_STEPS} steps eager: wrapper calls "
          f"{calls} (expected a step {per_step}, nothing else), the "
          f"embedding backward's sorts {sorts} (expected 1 a step)",
          flush=True)
    check(all(calls[n] == SHARD_STEPS * per_step.get(n, 0) for n in calls)
          and sorts == SHARD_STEPS, f"{placement}: launches {calls}, sorts "
          f"{sorts}")
    b_scan, scan = shard_run(cfg, hp, tr, params0, "scan",
                             placement=placement, grid=grid)
    leaves = lambda r: (r.params, r.opt_state)  # noqa: E731
    differ = tree_diff(leaves(eager), leaves(scan))
    eager_ms = 1e3 * sum(eager.step_seconds[1:]) / (SHARD_STEPS - 1)
    print(f"[{tag}] eager against the scan engine ({SCAN_STEPS} steps a "
          f"graph, its NCCL calls captured): params and state "
          f"{'bitwise equal' if not differ else f'DIFFER at {differ[:6]}'}"
          f", losses "
          f"{'bitwise equal' if eager.losses == scan.losses else 'DIFFER'}"
          f" (last {scan.losses[-1]:.6f}), overflow_shards "
          f"{eager.overflow_shards} / {scan.overflow_shards}; train_ctr's "
          f"ms/step (CUDA events): eager {eager_ms:.2f} (steps 2-"
          f"{SHARD_STEPS}), graph chunk with its capture "
          f"{1e3 * scan.step_seconds[0]:.1f}", flush=True)
    check(not differ and eager.losses == scan.losses,
          f"{placement}: the graph replays differ from the eager steps")
    check(eager.overflow_shards == scan.overflow_shards == 0,
          f"{placement}: overflow at the exact capacity")
    del eager, b_eager
    torch.cuda.empty_cache()

    # one step from the same params against the port's own placements
    want = "substrate" if placement == "sharded" else "sparse"
    others = (want, "fused") if placement == "sharded" else (want,)
    one = {p: exported(*shard_run(cfg, hp, tr, params0, "eager",
                                  placement=p, steps=1,
                                  grid=grid if p == placement else None))
           for p in (placement,) + others}
    worst, used = held_to(tag, one[placement], one[want], 1e-5, 1e-8)
    print(f"[{tag}] one step against the {want} placement from the same "
          f"params{' (flushed)' if want == 'sparse' else ''}: max_abs "
          f"{worst:.3e}, worst |err|/(atol + rtol*|{want}|) {used:.3f} "
          f"(rtol 1e-5, atol 1e-8)", flush=True)
    check(used <= 1.0, f"{placement} against {want} after a step")
    if placement == "sharded":
        f_worst, _ = held_to(tag, one[placement], one["fused"], 1e-5, 1e-8)
        print(f"[{tag}] one step against the fused placement: max_abs "
              f"{f_worst:.3e}", flush=True)
    del one
    torch.cuda.empty_cache()

    params, state = scan.params, scan.opt_state
    del scan
    if placement == "sharded_sparse":
        decay_check(tr, params, state, hp)
    chunk = {k: torch.as_tensor(v, device="cuda") for k, v in
             next(chunk_epoch(tr, BATCH, SCAN_STEPS, seed=4)).items()}
    runner = engine_lib.make_chunk_runner(b_scan.step.scan_step)
    runner(params, state, chunk)          # the capture and a first replay
    torch.cuda.synchronize()
    wall_ms, prof = profiled(lambda: runner(params, state, chunk))
    kernels = by_kernel(prof)
    group = FUSED_KERNELS if placement == "sharded" else SPARSE_KERNELS
    print_trace(tag, f"one replay of {SCAN_STEPS} steps", wall_ms, kernels,
                groups=(("the update's kernels", group), EMBED_GROUP,
                        NCCL_GROUP), steps=SCAN_STEPS)
    counts = {n: sum(c for _, c, k in kernels if n in k)
              for n in FUSED_KERNELS + SPARSE_KERNELS + EMBED_KERNELS}
    nccl = [(name, n, round(ms / SCAN_STEPS, 4)) for ms, n, name in kernels
            if "nccl" in name.lower()]
    theirs = torch_embedding_backward(kernels)
    reads = sum(e.name == HOST_READ for e in prof.events())
    levels = ref.levels(BATCH * cfg.n_fields)
    print(f"[{tag}] kernels of one replay: {counts}; NCCL's kernels "
          f"(name, launches in the replay, device ms a step) {nccl}; "
          f"PyTorch's embedding backward kernels {theirs}; host reads of a "
          f"scalar in the replay {reads}", flush=True)
    fused = sum(counts[n] for n in FUSED_KERNELS)
    want_counts = (fused == n_tables * SCAN_STEPS
                   and counts["sparse_catchup_kernel"] == 0
                   if placement == "sharded" else
                   fused == 0
                   and counts["sparse_catchup_kernel"] == SCAN_STEPS
                   and counts["sparse_update_kernel"] == SCAN_STEPS)
    check(reads == 0, f"{placement}: {reads} host reads in a replay")
    check(not theirs, f"{placement}: PyTorch's embedding backward {theirs}")
    check(want_counts and counts[EMBED_KERNELS[0]] == levels * SCAN_STEPS,
          f"{placement}: kernels of a replay {counts}")
    del prof

    # the collectives an eager step issues (c10d's ops on the host; on
    # one rank NCCL launches nothing for an in-place collective)
    batches = [{k: v[i] for k, v in chunk.items()} for i in range(2)]

    def two_steps():
        for batch in batches:
            b_scan.step(params, state, batch)

    wall_ms, prof = profiled(two_steps)
    coll = {e.key: (e.count, e.cpu_time_total / 1e3)
            for e in prof.key_averages() if e.key.startswith("c10d::")}
    n_coll = sum(c for c, _ in coll.values())
    want_coll = COLLECTIVES[placement]
    nccl_eager = [(name, n, round(ms, 4)) for ms, n, name in by_kernel(prof)
                  if "nccl" in name.lower()]
    print(f"[{tag}] 2 eager steps ({wall_ms:.1f} ms wall): collectives "
          f"{coll} (op: calls, host ms), {n_coll / 2:g} a step (expected "
          f"{want_coll}), their host time "
          f"{sum(t for _, t in coll.values()) / 2:.3f} ms a step; NCCL's "
          f"kernels {nccl_eager}", flush=True)
    check(n_coll == 2 * want_coll, f"{placement}: {n_coll} collectives in "
          f"2 eager steps, expected {want_coll} a step")
    del prof
    e_ms, g_ms = steady_ms(b_scan, runner, params, state, chunk,
                           rounds=SHARD_TIMED)
    print(f"[{tag}] steady ms/step (CUDA events around each chunk of "
          f"{SCAN_STEPS} steps on batches already on the card, eager and "
          f"graph in turns): eager {spread(e_ms)}, graph {spread(g_ms)}, "
          f"{kind} at {power}", flush=True)
    check(all(math.isfinite(x) and x > 0 for x in e_ms + g_ms),
          f"{placement}: a steady chunk time is not positive")
    del runner, chunk, params, state, b_scan, params0
    if placement == "sharded_sparse":
        overflow_small_phase(grid)
    print(f"[{tag}] phase in {time.perf_counter() - t0:.1f} s", flush=True)
    return calls


def decay_check(tr, params, state, hp):
    """The sharded_sparse forward's inline decay
    (``embed.sharded.decayed_lookup_partial``) against the catch-up
    kernel's rows for the same ids, on the largest table after a run, and
    with pending depths to 1000: bitwise."""
    from repro_torch.core.optim import decay_factor
    from repro_torch.embed import sharded as shard_lib
    from repro_torch.kernels import cowclip as cc
    from repro_torch.models.embedding import unique_ids

    vocabs = [t.shape[0] for t in params["embed"]["fm"].values()]
    f = int(np.argmax(vocabs))
    name = f"field_{f}"
    w, m, v = (t["fm"][name] for t in (params["embed"], state["m"],
                                       state["v"]))
    ls = state["last_step"]["fm"][name]
    gen = torch.Generator(device="cuda").manual_seed(5)
    deep = torch.randint(0, 1001, ls.shape, generator=gen, device="cuda",
                         dtype=torch.int32)
    col = torch.as_tensor(tr.ids[:BATCH, f], device="cuda")
    u = unique_ids(col, w.shape[0], BATCH)
    real = u.counts > 0
    factor = decay_factor(hp.emb_lr, hp.emb_l2)
    plan = shard_lib.RowShardPlan(w.shape[0], 1)
    for what, ls_, t in (("after the run", ls, int(state["step"]) + 1),
                         ("depths 0-1000", deep, 1002)):
        rows, _ = cc.sparse_gather_catchup_tables(
            [w], [m], [v], [ls_], [u.uids], [u.counts],
            cc.step_scalars(t, device="cuda"), lr=hp.emb_lr, l2=hp.emb_l2)
        got = shard_lib.decayed_lookup_partial(
            w, ls_, u.uids[real], plan, 0,
            torch.tensor(t, dtype=torch.int32, device="cuda"), factor)
        same = torch.equal(got, rows[0][0][real])
        print(f"[sharded_sparse-1x1] the forward's inline decay against the "
              f"catch-up kernel's rows, {what} ({int(real.sum())} rows of "
              f"field {f}, step {t}): "
              f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
        check(same, f"inline decay differs from the catch-up kernel, {what}")


def overflow_small_phase(grid):
    """Phase 34's small part: at phase 6's small size a capped slot
    capacity (SHARD_CAP) that overflows, SCAN_STEPS steps eager and in a
    replayed chunk (bitwise, the same overflow count, > 0), flushed and
    exported against the substrate on the card (rtol / atol 1e-5)."""
    from repro_torch.models import ctr

    cfg, hp, ds = small_setup("sharded_sparse")
    cfg = dataclasses.replace(cfg, unique_capacity=SHARD_CAP)
    tr, _ = ds.split(0.95)
    params0 = ctr.init(cfg, seed=2, device="cuda")
    runs = {e: shard_run(cfg, hp, tr, params0, e, placement="sharded_sparse",
                         grid=grid, batch=512) for e in ("eager", "scan")}
    sub = exported(*shard_run(cfg, hp, tr, params0, "eager",
                              placement="substrate", batch=512))
    flat = {e: exported(*r) for e, r in runs.items()}
    same = all(torch.equal(flat["eager"][k], flat["scan"][k]) for k in sub)
    over = [r[1].overflow_shards for r in runs.values()]
    worst, used = held_to("small", flat["scan"], sub, 1e-5, 1e-5)
    print(f"[sharded_sparse-small] capacity {SHARD_CAP} at phase 6's size, "
          f"{SCAN_STEPS} steps: overflow_shards eager / replayed chunk "
          f"{over}; eager against the replay "
          f"{'bitwise equal' if same else 'DIFFER'}; the replay's flushed "
          f"params against the substrate on the card: max_abs {worst:.3e}, "
          f"worst |err|/(atol + rtol*|substrate|) {used:.3f} (rtol 1e-5, "
          f"atol 1e-5)", flush=True)
    check(over[0] == over[1] > 0, f"overflow counts {over}")
    check(same, "capped sharded_sparse: the replay differs from eager")
    check(used <= 1.0, "capped sharded_sparse against the substrate")


def sharded_phases(tr, hp, power, kind):
    """Phases 33-34: the sharded placements at deepfm-criteo width on an
    NCCL world of one rank. Returns the wrappers' calls on each eager
    run, for the kernels' JSON line."""
    phase_start(33)
    sharded = sharded_phase("sharded", tr, hp, power, kind)
    phase_end()
    phase_start(34)
    hybrid = sharded_phase("sharded_sparse", tr, hp, power, kind)
    phase_end()
    return sharded, hybrid


SHARD_WRAPPERS = ("cowclip_adam_update", "sparse_gather_catchup",
                  "sparse_update_scatter", "embedding_backward")


def shard_wrappers():
    """{name: wrapper} of the kernels a sharded step may launch, their
    counts set to 0 (the single-table sparse wrappers too, which no step
    may call)."""
    from repro_torch.kernels import cowclip as cc
    from repro_torch.kernels.embedding import embedding_backward_groups

    wrappers = {"cowclip_adam_update": cc.fused_cowclip_adam,
                "sparse_gather_catchup": cc.sparse_gather_catchup_tables,
                "sparse_update_scatter": cc.sparse_update_scatter_tables,
                "embedding_backward": embedding_backward_groups,
                "sparse_gather_catchup (one table)":
                    cc.sparse_gather_catchup,
                "sparse_update_scatter (one table)":
                    cc.sparse_update_scatter}
    for w in wrappers.values():
        w.launches = 0
    return wrappers


def sharded_guard_phase(tr, hp, power, kind):
    """Phase 35: the non-finite guard on ``sharded`` and
    ``sharded_sparse`` (div) on an NCCL world of one rank, at
    deepfm-criteo width and batch BATCH from phase 19's initial params and
    batches, 4 steps a graph: guarded against unguarded over GUARD_STEPS
    clean steps through the scan engine, bitwise; a chunk whose 2nd batch
    holds a NaN: the eager guarded steps skip it (every leaf bitwise
    unchanged by it; the update kernels launch and write nothing) and the
    chunk's replay equals them; a traced guarded replay (the kernels a
    step, 0 host reads); the guard's ms a graph step beside the unguarded
    one, GUARD_TIMED replays each way in turns. Returns each placement's
    wrapper calls on its eager guarded steps."""
    from repro_torch.launch import mesh as mesh_lib

    with mesh_lib.process_group("cuda"):
        grid = mesh_lib.make_ctr_mesh(1, 1, device_type="cuda")
        calls = {}
        for placement in ("sharded", "sharded_sparse"):
            calls[placement] = _sharded_guard(placement, grid, tr, hp,
                                              power, kind)
            phase_end()
        del grid
    return calls


def _sharded_guard(placement, grid, tr, hp, power, kind):
    from repro_torch.configs.deepfm_criteo import CONFIG
    from repro_torch.core.tree import tree_map
    from repro_torch.data.prefetch import chunk_epoch
    from repro_torch.kernels.embedding import ref, sort_plan
    from repro_torch.models import ctr
    from repro_torch.train import engine as engine_lib

    tag = f"{placement}-guard"
    t0 = time.perf_counter()
    cfg = dataclasses.replace(CONFIG, emb_sigma=1e-2)
    params0 = ctr.init(cfg, seed=7, device="cuda")
    run = dict(placement=placement, grid=grid, steps=GUARD_STEPS)
    b_u, unguarded = shard_run(cfg, hp, tr, params0, "scan", **run)
    b_g, guarded = shard_run(cfg, hp, tr, params0, "scan", guard=True,
                             **run)
    del params0
    differ = tree_diff(state_of(unguarded), state_of(guarded))
    same_losses = guarded.losses == unguarded.losses
    print(f"[{tag}] guarded against unguarded {placement} on an NCCL world "
          f"of one rank, {GUARD_STEPS} clean steps, {SCAN_STEPS} a graph: "
          f"params, moments, {'last_step, ' if 'sparse' in placement else ''}"
          f"the tower's state and the step "
          f"{'bitwise equal' if not differ else f'DIFFER at {differ[:6]}'}"
          f", losses {'bitwise equal' if same_losses else 'DIFFER'}",
          flush=True)
    check(not differ and same_losses and all(
        math.isfinite(x) for x in guarded.losses),
        f"guarded {placement} differs from unguarded on clean batches")

    chunk = next(chunk_epoch(tr, BATCH, SCAN_STEPS, seed=4))
    chunk["dense"][1, 0, 0] = np.nan
    chunk = {k: torch.as_tensor(v, device="cuda") for k, v in chunk.items()}
    wrappers = shard_wrappers()
    sort_plan.sorts = 0
    p, s = tree_map(torch.clone, state_of(guarded))
    skipped, unchanged = [], None
    for i in range(SCAN_STEPS):
        before = tree_map(torch.clone, (p, s)) if i == 1 else None
        p, s, aux = b_g.step(p, s, {k: v[i] for k, v in chunk.items()})
        skipped.append(aux["skipped_steps"])
        if before is not None:
            unchanged = tree_diff(before, (p, s))
            del before
    torch.cuda.synchronize()
    calls = {name: w.launches for name, w in wrappers.items()}
    sorts = sort_plan.sorts
    skipped = [int(x) for x in skipped]
    eager = (p, s)
    p, s = tree_map(torch.clone, state_of(guarded))
    runner_g = engine_lib.make_chunk_runner(b_g.step.scan_step)
    p, s, aux = runner_g(p, s, chunk)
    replay_differ = tree_diff(eager, (p, s))
    n_skipped = int(aux["skipped_steps"].sum())
    n_tables = 2 * cfg.n_fields
    per_step = ({"cowclip_adam_update": n_tables, "embedding_backward": 1}
                if placement == "sharded" else
                {"sparse_gather_catchup": 1, "sparse_update_scatter": 1,
                 "embedding_backward": 1})
    print(f"[{tag}] a NaN batch 2nd of a chunk of {SCAN_STEPS}: eager "
          f"guarded steps skipped {skipped}, the poisoned step left every "
          f"leaf "
          f"{'bitwise unchanged' if not unchanged else f'CHANGED at {unchanged[:6]}'}"
          f"; the graph's replay skipped {n_skipped}, the step "
          f"{int(s['step'])}, "
          f"{'bitwise equal to' if not replay_differ else 'DIFFERS from'} "
          f"the eager steps; wrapper calls of the {SCAN_STEPS} eager steps "
          f"{calls} (expected a step {per_step}, nothing else), the "
          f"embedding backward's sorts {sorts} (expected 1 a step)",
          flush=True)
    check(skipped == [0, 1, 0, 0][:SCAN_STEPS] and not unchanged
          and n_skipped == 1 and not replay_differ
          and int(s["step"]) == GUARD_STEPS + SCAN_STEPS - 1,
          f"{placement}: the guard under a graph ({replay_differ[:4]})")
    check(all(calls[n] == SCAN_STEPS * per_step.get(n, 0) for n in calls)
          and sorts == SCAN_STEPS,
          f"guarded {placement}: launches {calls}, sorts {sorts}")
    del eager, aux

    # one more replay of the poisoned chunk, traced
    wall_ms, prof = profiled(lambda: runner_g(p, s, chunk))
    kernels = by_kernel(prof)
    counts = {n: sum(c for _, c, k in kernels if n in k)
              for n in FUSED_KERNELS + SPARSE_KERNELS + EMBED_KERNELS}
    reads = sum(e.name == HOST_READ for e in prof.events())
    theirs = torch_embedding_backward(kernels)
    levels = ref.levels(BATCH * cfg.n_fields)
    fused = sum(counts[n] for n in FUSED_KERNELS)
    print(f"[{tag}] one guarded replay traced ({wall_ms:.1f} ms wall for "
          f"{SCAN_STEPS} steps): kernels {counts}; PyTorch's embedding "
          f"backward kernels {theirs}; host reads of a scalar {reads}",
          flush=True)
    want_counts = (fused == n_tables * SCAN_STEPS
                   and counts["sparse_catchup_kernel"] == 0
                   if placement == "sharded" else
                   fused == 0
                   and counts["sparse_catchup_kernel"] == SCAN_STEPS
                   and counts["sparse_update_kernel"] == SCAN_STEPS)
    check(reads == 0 and not theirs and want_counts
          and counts[EMBED_KERNELS[0]] == levels * SCAN_STEPS,
          f"guarded {placement} replay: kernels {counts}, host reads "
          f"{reads}")
    del prof

    clean = {k: torch.as_tensor(v, device="cuda") for k, v in
             next(chunk_epoch(tr, BATCH, SCAN_STEPS, seed=6)).items()}
    pu, su = state_of(unguarded)
    runner_u = engine_lib.make_chunk_runner(b_u.step.scan_step)
    runner_u(pu, su, clean)
    runner_g(p, s, clean)
    torch.cuda.synchronize()
    spans = {"unguarded": [], "guarded": []}
    for _ in range(GUARD_TIMED):
        for name, fn in (("unguarded", lambda: runner_u(pu, su, clean)),
                         ("guarded", lambda: runner_g(p, s, clean))):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            spans[name].append((a, b))
    torch.cuda.synchronize()
    ms = {n: [a.elapsed_time(b) / SCAN_STEPS for a, b in v]
          for n, v in spans.items()}
    print(f"[{tag}] ms a graph step (CUDA events around each replay of "
          f"{SCAN_STEPS} steps, in turns): unguarded "
          f"{spread(ms['unguarded'])}, guarded {spread(ms['guarded'])}; "
          f"{kind} at {power}", flush=True)
    check(all(math.isfinite(x) and x > 0 for v in ms.values() for x in v),
          f"guarded {placement} timing")
    del runner_g, runner_u, p, s, pu, su, chunk, clean, b_g, b_u
    del guarded, unguarded
    print(f"[{tag}] in {time.perf_counter() - t0:.1f} s", flush=True)
    return {n: calls[n] for n in SHARD_WRAPPERS}


def stream_batches(tr, batch, chunk, start=0):
    """Phase 36's online batches: the train split replayed as an event
    stream (half a batch an event, seed 5), from step ``start``'s first
    row, in chunks of ``chunk`` steps."""
    from repro_torch.data import stream as stream_lib

    events = stream_lib.synthetic_event_stream(
        tr, rows_per_event=batch // 2, seed=5)
    if start:
        events = stream_lib.skip_rows(events, start * batch)
    return stream_lib.stream_chunks(events, batch, chunk,
                                    start_rows=start * batch)


def stream_resume(tag, cfg, hp, tr, params0, grid, root, *, batch):
    """STREAM_STEPS online steps of ``cfg.placement`` (div) through
    ``train_ctr(mode="stream")``, SCAN_STEPS a graph, with a snapshot
    at STREAM_SNAP; a fresh bundle resumed from that snapshot and run to
    STREAM_STEPS, against the uninterrupted run: bitwise. Prints the
    snapshot's bytes and seconds by part, the resume's seconds and the
    online ms a step."""
    from repro_torch.core.tree import tree_map
    from repro_torch.embed import store_for
    from repro_torch.models import ctr
    from repro_torch.train import snapshot as snap_lib
    from repro_torch.train import train_ctr

    store = store_for(cfg, mesh=grid)
    token = snap_lib.placement_token(store)
    mgr = snap_lib.SnapshotManager(os.path.join(root, tag), retain=2)
    warm = max(1, len(tr) // batch)
    taken = []

    def cb(p, s, n):
        if n == STREAM_SNAP:
            t0 = time.perf_counter()
            p, s = snap_lib.capture(
                mgr, b_w, p, s, step=n, cursor={"rows_consumed": n * batch},
                meta={"placement": token, "snapshot_every": STREAM_SNAP})
            taken.append((n, time.perf_counter() - t0,
                          dict(mgr.last_timings)))
        return p, s

    b_w = store.make_bundle(cfg, hp, warmup_steps=warm)
    p = b_w.prepare(tree_map(torch.clone, params0))
    whole = train_ctr(cfg, None, tr, None, batch_size=batch,
                      step_bundle=b_w, max_steps=STREAM_STEPS,
                      engine="scan", mode="stream",
                      stream=stream_batches(tr, batch, SCAN_STEPS),
                      init_state=(p, b_w.init(p)), snapshot_cb=cb,
                      device="cuda")
    del p
    check([n for n, _, _ in taken] == [STREAM_SNAP], f"snapshots {taken}")
    _, wall, t = taken[0]
    steady = whole.step_seconds[SCAN_STEPS:]
    print(f"[{tag}] {STREAM_STEPS} online steps ({SCAN_STEPS} a graph), "
          f"a snapshot at step {STREAM_SNAP}: {wall:.2f} s of stall (flush "
          f"{t['flush']:.2f}, export with the state's gather and the copy "
          f"to the host {t['export']:.2f}, write with fsync "
          f"{t['write']:.2f}, sha256 {t['sha256']:.2f}, manifest with "
          f"rename and rotation {t['manifest']:.2f}), payload {t['bytes']} "
          f"B; online ms a step: the host clock over train_ctr's "
          f"{STREAM_STEPS} steps (the graphs' captures and the snapshot "
          f"included) {1e3 * whole.seconds / STREAM_STEPS:.1f}, the steps "
          f"alone (CUDA events, chunks 2-{STREAM_STEPS // SCAN_STEPS}) "
          f"{1e3 * np.mean(steady):.3f}", flush=True)

    b_r = store.make_bundle(cfg, hp, warmup_steps=warm)
    t0 = time.perf_counter()
    restored = snap_lib.resume(mgr, b_r, ctr.init(cfg, seed=8,
                                                  device="cuda"),
                               token=token)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    check(restored is not None, f"{tag}: no valid snapshot")
    rp, rs, start, cursor = restored
    del restored
    print(f"[{tag}] resumed from step {start} (cursor {cursor}) in "
          f"{resume_s:.2f} s (validate the checksums, load, overlay on the "
          f"host, keep the rank's blocks, copy to the card)", flush=True)
    check(start == STREAM_SNAP and int(rs["step"]) == STREAM_SNAP,
          f"{tag}: resumed at {start}")
    resumed = train_ctr(cfg, None, tr, None, batch_size=batch,
                        step_bundle=b_r, max_steps=STREAM_STEPS,
                        engine="scan", mode="stream",
                        stream=stream_batches(tr, batch, SCAN_STEPS, start),
                        init_state=(rp, rs), start_step=start,
                        device="cuda")
    del rp, rs
    differ = tree_diff(state_of(whole), state_of(resumed))
    same_losses = whole.losses[STREAM_SNAP:] == resumed.losses
    print(f"[{tag}] resumed at step {start} in a fresh bundle, run to "
          f"{STREAM_STEPS}, against the uninterrupted run with the same "
          f"cadence: params, moments, "
          f"{'last_step, ' if 'sparse' in cfg.placement else ''}the tower's "
          f"state and the step "
          f"{'bitwise equal' if not differ else f'DIFFER at {differ[:6]}'}"
          f", losses of steps {start + 1}-{STREAM_STEPS} "
          f"{'bitwise equal' if same_losses else 'DIFFER'}", flush=True)
    check(not differ and same_losses, f"{tag}: the resumed run differs")
    return t


def sharded_stream_phase(tr, hp, power, kind):
    """Phase 36: streaming with snapshots on the sharded placements, on an
    NCCL world of one rank. ``sharded_sparse`` (div) at deepfm-criteo
    width, batch BATCH, phase 19's initial params (``stream_resume``),
    then ``sharded`` (div) the same way at phase 6's small size; then the
    CLI (``--placement sharded_sparse --mode stream``, a world of one rank
    of its own) killed in a child process by a FaultPlan inside its step-8
    snapshot write and run again with ``--resume``: bitwise equal to its
    uninterrupted run. Snapshots go under build/, removed after."""
    import shutil

    from repro_torch.configs.deepfm_criteo import CONFIG
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import ctr

    root = snap_dir()
    try:
        with mesh_lib.process_group("cuda"):
            grid = mesh_lib.make_ctr_mesh(1, 1, device_type="cuda")
            cfg = dataclasses.replace(CONFIG, emb_sigma=1e-2,
                                      placement="sharded_sparse")
            t0 = time.perf_counter()
            stream_resume("sharded_sparse-stream", cfg, hp, tr,
                          ctr.init(cfg, seed=7, device="cuda"), grid, root,
                          batch=BATCH)
            print(f"[sharded_sparse-stream] {kind} at {power}; in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            phase_end()
            scfg, shp, ds = small_setup("sharded")
            stream_resume("sharded-stream-small", scfg, shp, ds,
                          ctr.init(scfg, seed=2, device="cuda"), grid, root,
                          batch=512)
            del grid
        phase_end()
        sharded_cli_kill(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def sharded_cli_kill(root):
    """The CLI with ``--placement sharded_sparse --mode stream`` on the
    card (a world of one rank): uninterrupted with snapshots every 4
    steps; killed in a child process by ``FaultPlan(kill_at_step=8,
    kill_in_snapshot=True)``; then ``--resume``: the checkpoints' params
    bitwise equal."""
    import contextlib
    import io

    from repro_torch.launch import train as launch
    from repro_torch.testing import FaultPlan

    src = Path(__file__).resolve().parent / "src"
    args = ["--task", "ctr", "--mode", "stream", "--steps", "12",
            "--samples", "4096", "--batch", "256", "--base-batch", "256",
            "--snapshot-every", "4", "--placement", "sharded_sparse",
            "--engine", "scan", "--scan-steps", "2"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch.main(args + ["--snapshot-dir", os.path.join(root, "ref"),
                            "--checkpoint", os.path.join(root, "ref.npz")])
    plan = FaultPlan(kill_at_step=8, kill_in_snapshot=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(src) + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
    env.update(plan.to_env())
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train"] + args
        + ["--snapshot-dir", os.path.join(root, "cli")], env=env,
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    child_s = time.perf_counter() - t0
    listing = sorted(os.listdir(os.path.join(root, "cli")))
    with contextlib.redirect_stdout(out):
        launch.main(args + ["--snapshot-dir", os.path.join(root, "cli"),
                            "--resume", "--checkpoint",
                            os.path.join(root, "resumed.npz")])
    with np.load(os.path.join(root, "ref.npz")) as a, \
            np.load(os.path.join(root, "resumed.npz")) as b:
        keys = [k for k in a.files if k.startswith("params/")]
        same = (keys and set(keys) == {k for k in b.files
                                       if k.startswith("params/")}
                and all(np.array_equal(a[k], b[k]) for k in keys))
    resumed_at = [ln for ln in out.getvalue().splitlines()
                  if "resumed from snapshot step" in ln]
    print(f"[sharded-cli] the CLI with --placement sharded_sparse --mode "
          f"stream on the card (an NCCL world of one rank) under "
          f"FaultPlan(kill_at_step=8, kill_in_snapshot=True): the child "
          f"exited {child.returncode} in {child_s:.1f} s leaving {listing}; "
          f"--resume: {resumed_at}; params "
          f"{'bitwise equal' if same else 'DIFFER'} to the uninterrupted "
          f"run's", flush=True)
    check(child.returncode == -9, "the child was not killed: "
          + child.stderr[-2000:])
    check("snap-00000008.tmp" in listing and "snap-00000008" not in listing,
          f"snapshots {listing}")
    check(resumed_at and "step 4" in resumed_at[0] and same,
          "the sharded CLI's resumed run differs")


def graph_phases(smi, kind):
    """Phases 19-22, 25-36: the scan engine at deepfm-criteo width on
    the fused and sparse placements, the guard under a graph, CTR serving,
    the substrate at full width and its clips at a small size, the
    hot/cold tiers, durability, the sharded placements, and their guard,
    snapshots and streaming. Every tensor is freed on return."""
    power = smi.strip().split(", ")[-1]
    t0 = time.perf_counter()
    tr, te = criteo_data(steps=GRAPH_STEPS, seed=1)
    print(f"[graph] synthetic Zipf data: {len(tr)} train / {len(te)} test "
          f"rows in {time.perf_counter() - t0:.1f} s", flush=True)
    hp = criteo_hypers()
    phase_start(19)
    fused = graph_engine_phase("fused", tr, hp, power, kind)
    phase_end()
    phase_start(20)
    graph_engine_phase("sparse", tr, hp, power, kind)
    phase_end()
    phase_start(21)
    guard_phase(power, kind)
    phase_end()
    phase_start(22)
    serving_phase(*fused, tr, te, power, kind)
    del fused
    phase_end()
    phase_start(25)
    substrate_phase(tr, te, hp, power, kind)
    phase_end()
    phase_start(26)
    clip_phase()
    phase_end()
    calls = hotcold_phases(tr, hp, power, kind)
    guarded = durability_phases(tr, hp, power, kind)
    sharded = sharded_phases(tr, hp, power, kind)
    phase_start(35)
    sharded_guarded = sharded_guard_phase(tr, hp, power, kind)
    phase_end()
    phase_start(36)
    sharded_stream_phase(tr, hp, power, kind)
    phase_end()
    return calls, guarded, sharded, sharded_guarded


def wkv_inputs(gen, bh, seq, n, zero_frac=0.0):
    """The JAX kernel tests' distribution (``tests/test_kernels.py:
    _wkv_inputs``), drawn on the card: r, k, v ~ N(0, 1), w =
    exp(-exp(wlog)) with wlog ~ N(-0.6, 1), u ~ N(0, 0.01); ``zero_frac``
    of the decays set to exactly 0."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    r, k, v = randn(bh, seq, n), randn(bh, seq, n), randn(bh, seq, n)
    w = torch.exp(-torch.exp(-0.6 + randn(bh, seq, n)))
    if zero_frac:
        drop = torch.rand((bh, seq, n), generator=gen, device="cuda")
        w = torch.where(drop < zero_frac, 0.0, w)
    return r, k, v, w, 0.1 * randn(bh, n)


def wkv_compare(tag, got, want, worst=None, hold_y=True):
    """Hold the kernel's ``(y, state)`` to a plain version's at the JAX
    kernel test's bar (max |dy| / max |y| < WKV_Y_REL; the state within
    WKV_S_RTOL / WKV_S_ATOL) and print both errors; with ``worst``, fold
    the max abs error into ``worst[0]``. With ``hold_y`` False, y's error
    is reported and only the state is held."""
    (y, s), (y_ref, s_ref) = got, want
    y_err = (y - y_ref).abs().max().item()
    y_rel = y_err / (y_ref.abs().max().item() + 1e-6)
    s_err = (s - s_ref).abs().max().item()
    s_ok = torch.allclose(s, s_ref, rtol=WKV_S_RTOL, atol=WKV_S_ATOL)
    y_ok = y_rel < WKV_Y_REL
    if worst is not None:
        worst[0] = max(worst[0], y_err, s_err)
    print(f"[wkv6] {tag}: y max_abs {y_err:.3e}, / max|y| {y_rel:.3e} "
          f"({'ok' if y_ok else 'FAIL'} at {WKV_Y_REL}"
          f"{'' if hold_y else ', reported, not held'}); state max_abs "
          f"{s_err:.3e} ({'ok' if s_ok else 'FAIL'} at rtol {WKV_S_RTOL} / "
          f"atol {WKV_S_ATOL})", flush=True)
    check(s_ok and (y_ok or not hold_y),
          f"wkv6 kernel disagrees with a plain version: {tag}")


def wkv_bound(bh, seq, n, chunk=16):
    """Least time for one call: r, k, v, w read and y written once, u read,
    the final state written (f32); 4*L*L*N + 4*L*N*N operations per
    (bh, chunk): A, A v, r S and the state update."""
    nbytes = 4 * (5 * bh * seq * n + bh * n + bh * n * n)
    flops = bh * (seq // chunk) * (4 * chunk * chunk * n + 4 * chunk * n * n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, flops


def lm_phases(smi, kind):
    """Phases 13-18, RWKV-6 serving at rwkv6-7b width and the wkv6 kernel.
    Returns the kernel's JSON line."""
    from repro_torch.configs import reduce_config
    from repro_torch.configs.rwkv6_7b import CONFIG as RWKV6_7B
    from repro_torch.core.tree import tree_map
    from repro_torch.data import make_lm_tokens
    from repro_torch.kernels.cowclip import (fused_cowclip_adam,
                                             sparse_gather_catchup,
                                             sparse_update_scatter)
    from repro_torch.kernels.wkv6 import (chunked_wkv6_reference,
                                          clipped_chunks,
                                          segmented_wkv6_reference, wkv6,
                                          wkv6_reference)
    from repro_torch.kernels.wkv6.wkv6 import chunked_wkv6, segment_chunks
    from repro_torch.models import layers, lm, rwkv
    from repro_torch.serve.decode import GraphDecoder, greedy_generate

    power = smi.strip().split(", ")[-1]
    gen = torch.Generator(device="cuda").manual_seed(14)
    err = [0.0]

    # -- 13. wkv6 kernel vs its plain versions ---------------------------
    phase_start(13)
    torch.cuda.reset_peak_memory_stats()
    cases = [(f"[{bh}, {seq}, {n}] chunk {chunk}{' zeros' if z else ''}",
              bh, seq, n, chunk, z)
             for bh, seq, n, chunk, z in (
                 (2, 32, 16, 16, 0.0), (4, 64, 32, 16, 0.0),
                 (1, 128, 64, 16, 0.0), (8, 48, 8, 16, 0.0),
                 (2, 64, 16, 4, 0.0), (2, 64, 16, 8, 0.0),
                 (4, 64, 32, 16, 0.05), WKV_FULL + (16, 0.0))]
    for tag, bh, seq, n, chunk, zeros in cases:
        inp = wkv_inputs(gen, bh, seq, n, zeros)
        with torch.inference_mode():
            got = wkv6(*inp, chunk=chunk)
            chunked = chunked_wkv6_reference(*inp, chunk=chunk)
            exact = wkv6_reference(*inp)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in got),
              f"non-finite wkv6 output at {tag}")
        clipped = clipped_chunks(inp[3], chunk=chunk)
        wkv_compare(f"{tag} vs chunked plain", got, chunked, err)
        # the factorisation equals the recurrence only where no chunk's
        # decay passes its +-25 clip; the state, carried unclipped, always
        wkv_compare(f"{tag} vs exact recurrence ({clipped} clipped "
                    f"chunk-channels)", got, exact, hold_y=clipped == 0)
        del inp, got, chunked, exact
    # the redesign's edges, through the launcher with the card's segment
    # choice (None) or a forced one, also against the segmented plain
    # version of the same split
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for bh, seq, n, chunk, segment, zeros in (
            (3, 16, 64, 16, None, 0.0), (1, 16, 8, 16, None, 0.0),
            (1, 80, 16, 16, 2, 0.0), (1, 112, 32, 8, 3, 0.0),
            (2, 64, 64, 4, 5, 0.0), (1, 4096, 64, 16, None, 0.0),
            (2, 96, 16, 16, 1, 0.05), (1, 256, 64, 16, 3, 0.05),
            (1, 32768, 64, 16, None, 0.0)):
        seg = segment or segment_chunks(bh, seq // chunk, sms)
        tag = (f"edge [{bh}, {seq}, {n}] chunk {chunk} segment {seg}"
               f"{'' if segment else ' (the card default)'}"
               f"{' zeros' if zeros else ''}")
        inp = wkv_inputs(gen, bh, seq, n, zeros)
        with torch.inference_mode():
            got = chunked_wkv6(*inp, chunk=chunk, segment=segment)
            chunked = chunked_wkv6_reference(*inp, chunk=chunk)
            segmented = segmented_wkv6_reference(*inp, chunk=chunk,
                                                 segment=seg)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in got),
              f"non-finite wkv6 output at {tag}")
        wkv_compare(f"{tag} vs chunked plain", got, chunked, err)
        wkv_compare(f"{tag} vs segmented plain", got, segmented, err)
        del inp, got, chunked, segmented
    inp = wkv_inputs(gen, *WKV_LONG)
    with torch.inference_mode():
        got = wkv6(*inp)
        want = chunked_wkv6_reference(*inp)
    wkv_compare(f"{list(WKV_LONG)} chunk 16 vs chunked plain", got, want,
                err)
    del inp, got, want
    ragged = wkv_inputs(gen, 1, 40, 8)
    try:
        wkv6(*ragged)
    except ValueError as exc:
        print(f"[wkv6] [1, 40, 8] chunk 16 raises ValueError: {exc}")
    else:
        check(False, "a ragged sequence did not raise")
    torch.cuda.empty_cache()

    peak_line(13)
    # -- 14. rwkv6-7b at full width: score-only prefill (the main path) --
    phase_start(14)
    cfg = dataclasses.replace(RWKV6_7B, wkv_backend="chunked")
    n_params = lm.param_counts(cfg)["total"]
    check(cfg.n_layers == 32 and cfg.d_model == 4096 and cfg.n_heads == 64
          and cfg.d_ff == 14336 and cfg.vocab_size == 65536
          and cfg.compute_dtype == "bfloat16", "not the rwkv6-7b width")
    check(n_params == RWKV6_7B_PARAMS, f"{n_params} parameters")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[lm] rwkv6-7b: {n_params} parameters (f32, "
          f"{4 * n_params / 1e9:.1f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; bf16 compute, wkv_backend "
          f"chunked", flush=True)
    prompts = {
        (b, s): torch.as_tensor(
            make_lm_tokens(b * s, cfg.vocab_size, seed=s).reshape(b, s),
            device="cuda")
        for b, s in (LM_PREFILL, LM_LONG, LM_RAGGED)}

    def prefill(shape):
        with torch.inference_mode():
            out = lm.prefill(params, cfg, prompts[shape])
        torch.cuda.synchronize()
        return out

    counters = (wkv6, fused_cowclip_adam, sparse_gather_catchup,
                sparse_update_scatter)
    for fn in counters:
        fn.launches = 0
    first_s, per_forward = {}, []
    for shape in (LM_PREFILL, LM_LONG, LM_RAGGED):
        t0 = time.perf_counter()
        last = prefill(shape)
        first_s[shape] = time.perf_counter() - t0
        per_forward.append(wkv6.launches - sum(per_forward))
        check(tuple(last.shape) == (shape[0], cfg.padded_vocab)
              and bool(torch.isfinite(last).all()),
              f"prefill {shape}: logits {tuple(last.shape)} not finite")
    launches = wkv6.launches
    others = [fn.launches for fn in counters[1:]]
    print(f"[lm] main path: prefill {list(LM_PREFILL)}, {list(LM_LONG)} "
          f"and {list(LM_RAGGED)}: wkv6 launches {per_forward} (expected "
          f"{cfg.n_layers} per forward), CowClip kernels {others} "
          f"(expected 0); logits finite", flush=True)
    check(per_forward == [cfg.n_layers] * 3,
          f"wkv6 launched {per_forward} times, expected {cfg.n_layers} per "
          f"forward")
    check(not any(others), f"CowClip kernels launched {others} times")
    for shape in (LM_PREFILL, LM_LONG, LM_RAGGED):
        t0 = time.perf_counter()
        for _ in range(LM_REPEATS):
            prefill(shape)
        ms = (time.perf_counter() - t0) * 1e3 / LM_REPEATS
        tokens = shape[0] * shape[1]
        print(f"[lm] prefill {list(shape)}: {ms:.1f} ms ({tokens / ms * 1e3:.0f} "
              f"tokens/s; first call {first_s[shape] * 1e3:.1f} ms), mean of "
              f"{LM_REPEATS}, {kind} at {power}", flush=True)
    print(f"[lm] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB (params {4 * n_params / 2**30:.2f} GiB)", flush=True)

    # -- 15. greedy generation, and layer 0's real streams ---------------
    phase_start(15)
    torch.cuda.reset_peak_memory_stats()
    gen_prompt = torch.as_tensor(make_lm_tokens(
        GEN_BATCH * GEN_PROMPT, cfg.vocab_size, seed=2).reshape(
            GEN_BATCH, GEN_PROMPT), device="cuda")
    # phase 23 beside it: the decode step as a replayed CUDA graph
    phase_start(23)
    t0 = time.perf_counter()
    decoder = GraphDecoder(params, cfg)
    decoder.graph(GEN_BATCH, GEN_PROMPT + GEN_NEW)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    timing, gen_launches, gens = {}, [], {}
    for mode in ("eager", "graph"):
        for new in (0, GEN_NEW):
            wkv6.launches = 0
            t0 = time.perf_counter()
            gens[mode] = greedy_generate(params, cfg, gen_prompt, new,
                                         decoder=decoder,
                                         graph=mode == "graph")
            torch.cuda.synchronize()
            timing[mode, new] = time.perf_counter() - t0
            gen_launches.append(wkv6.launches)
    res = gens["eager"]
    check(gen_launches == [cfg.n_layers] * 4,
          f"greedy generation launched wkv6 {gen_launches} times, expected "
          f"{cfg.n_layers} per cached prefill and none in decode")
    check(tuple(res.tokens.shape) == (GEN_BATCH, GEN_NEW)
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all())
          and bool(torch.isfinite(res.logits).all()),
          "greedy generation: bad tokens or non-finite logits")
    decode_ms = {mode: (timing[mode, GEN_NEW] - timing[mode, 0]) * 1e3
                 / GEN_NEW for mode in ("eager", "graph")}
    print(f"[gen] {GEN_BATCH} requests x {GEN_PROMPT}-token prompts, "
          f"{GEN_NEW} greedy tokens, eager decode steps: cached prefill "
          f"{timing['eager', 0] * 1e3:.1f} ms, {decode_ms['eager']:.2f} ms "
          f"per decoded token ({GEN_BATCH * 1e3 / decode_ms['eager']:.0f} "
          f"tokens/s), {kind} at {power}; wkv6 launches {gen_launches}; "
          f"first tokens {res.tokens[0, :8].tolist()}", flush=True)
    same = torch.equal(gens["graph"].tokens, res.tokens)
    gap = (gens["graph"].logits - res.logits).abs().max().item()
    print(f"[decode-graph] the decode step captured once for batch "
          f"{GEN_BATCH} ({capture_s:.2f} s with its warm-up step): "
          f"{decode_ms['graph']:.2f} ms per decoded token "
          f"({GEN_BATCH * 1e3 / decode_ms['graph']:.0f} tokens/s) against "
          f"{decode_ms['eager']:.2f} eager; tokens "
          f"{'equal to' if same else 'DIFFER from'} the eager ones, last "
          f"logits max_abs {gap:.3e} (bar {LM_AGREE}), {kind} at {power}",
          flush=True)
    check(same and gap <= LM_AGREE and list(decoder.graphs) == [(GEN_BATCH, None)],
          "the decode graph's generation differs from the eager one")
    with torch.inference_mode():
        p0 = tree_map(lambda t: t[0], params["dense"]["blocks"]["pos_0"])
        x = params["embed"]["tokens"][prompts[LM_PREFILL][:1]].to(cfg.dtype)
        h = layers.rmsnorm(p0["norm1"], x, cfg.norm_eps)
        b, s, d = h.shape
        streams = rwkv._streams(p0["att"], h.reshape(s, d),
                                torch.cat([torch.zeros_like(h[:, :1]),
                                           h[:, :-1]], 1).reshape(s, d),
                                cfg.dtype)
        n = d // cfg.n_heads

        def heads(t):
            return (t.to(torch.float32).reshape(s, cfg.n_heads, n)
                    .transpose(0, 1).contiguous())

        r, k, v, w = (heads(streams[i]) for i in (0, 1, 2, 4))
        u = p0["att"]["u"].reshape(cfg.n_heads, n).contiguous()
        got = wkv6(r, k, v, w, u)
        want = wkv6_reference(r, k, v, w, u)
    clipped = clipped_chunks(w)
    wkv_compare(f"layer 0's streams, one {s}-token prompt [{cfg.n_heads}, "
                f"{s}, {n}] vs exact recurrence ({clipped} clipped "
                f"chunk-channels)", got, want)
    del p0, x, h, streams, r, k, v, w, u, got, want, res

    peak_line("15 and 23")
    # -- 16. where a full-width prefill's and a decode step's time goes --
    phase_start(16)
    torch.cuda.reset_peak_memory_stats()
    print_trace("lm-trace", f"prefill {list(LM_PREFILL)}",
                *device_time_by_kernel(lambda: prefill(LM_PREFILL)),
                groups=(("the wkv6 scan's kernels", WKV6_KERNELS),))
    with torch.inference_mode():
        first, cache, cur = lm.prefill_with_cache(params, cfg, gen_prompt,
                                                  GEN_PROMPT + 1)

    def decode_one():
        with torch.inference_mode():
            lm.decode_step(params, cfg, first.argmax(-1), cache, cur)

    print_trace("lm-trace", f"decode step, batch {GEN_BATCH}",
                *device_time_by_kernel(decode_one))
    step_graph = decoder.graph(GEN_BATCH, GEN_PROMPT + 1)
    step_graph.start(first.argmax(-1), cache, cur)
    print_trace("lm-trace", f"decode step as a graph replay, batch "
                f"{GEN_BATCH}", *device_time_by_kernel(step_graph.step))
    del first, cache, step_graph, decoder, gens
    del params, prompts, gen_prompt
    gc.collect()
    torch.cuda.empty_cache()

    peak_line(16)
    # -- 17. agreement with the CPU path at the reduced f32 size ---------
    phase_start(17)
    torch.cuda.reset_peak_memory_stats()
    small = dataclasses.replace(reduce_config(RWKV6_7B), wkv_backend="chunked")
    params0 = lm.init(small, seed=0, device="cpu")
    feed = torch.as_tensor(make_lm_tokens(4 * 2, small.vocab_size,
                                          seed=4).reshape(4, 2))
    for seq in (64, 61):        # a whole number of chunks, and a ragged one
        tokens = torch.as_tensor(make_lm_tokens(2 * seq, small.vocab_size,
                                                seed=3).reshape(2, seq))
        runs = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), params0)
            wkv6.launches = 0
            with torch.inference_mode():
                logits, _ = lm.forward(p, small, tokens.to(dev))
                last, cache, cur = lm.prefill_with_cache(
                    p, small, tokens.to(dev), seq + 4)
                outs = [logits, last]
                for i in range(4):
                    last, cache = lm.decode_step(p, small, feed[i].to(dev),
                                                 cache, cur + i)
                    outs.append(last)
            want = 2 * small.n_layers if dev == "cuda" else 0
            check(wkv6.launches == want,
                  f"{dev}: wkv6 launched {wkv6.launches} times in a forward "
                  f"and a cached prefill, expected {want}")
            runs[dev] = [t.cpu() for t in outs]
        for what, i in (("chunked forward logits", 0),
                        ("cached prefill last logits", 1)):
            gap = (runs["cuda"][i] - runs["cpu"][i]).abs().max().item()
            print(f"[lm-agree] reduced rwkv6-7b (f32), {seq} tokens, {what}, "
                  f"card vs CPU: max_abs {gap:.3e} (bar {LM_AGREE})")
            check(gap <= LM_AGREE, f"card and CPU disagree on the {what}")
        gap = max((a - c).abs().max().item()
                  for a, c in zip(runs["cuda"][2:], runs["cpu"][2:]))
        print(f"[lm-agree] {seq} tokens, then 4 decode steps fed the same "
              f"tokens, card vs CPU: max_abs {gap:.3e} (bar {LM_AGREE})")
        check(gap <= LM_AGREE, "card and CPU disagree on decode logits")

    peak_line(17)
    # -- 18. kernel times: L2 flushed before each launch -----------------
    phase_start(18)
    torch.cuda.reset_peak_memory_stats()
    scratch = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    times = {}
    for shape in (WKV_FULL, WKV_LONG):
        inp = wkv_inputs(gen, *shape)
        with torch.inference_mode():
            k_ms = cuda_time_cold_ms(lambda: wkv6(*inp), 20, scratch)
            p_ms = cuda_time_cold_ms(lambda: chunked_wkv6_reference(*inp), 3,
                                     scratch)
        b_ms, b_by, nbytes, flops = wkv_bound(*shape)
        other = (flops / FP32_FLOPS_PER_S if b_by == "bytes"
                 else nbytes / HBM_BYTES_PER_S) * 1e3
        times[shape] = (k_ms, p_ms, b_ms, b_by)
        print(f"[time] chunked_wkv6 {list(shape)} (L2 flushed): kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms by "
              f"{b_by} ({nbytes} B at {HBM_BYTES_PER_S / 1e12} TB/s; {flops} "
              f"FLOP at {FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s f32 is "
              f"{other:.4f} ms), {kind} at {power}", flush=True)
        del inp
    del scratch
    peak_line(18)
    k_ms, p_ms, b_ms, b_by = times[WKV_FULL]
    return {
        "name": "chunked_wkv6",
        "route": "cuda",
        "source": "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6/wkv6.py:93",
        "launches": launches,
        "max_abs_err": err[0],
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }


def kv_bytes(cache):
    """Bytes of a decode cache's KV buffers."""
    from repro_torch.core.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(cache))


def peak_line(phase):
    """The device's peak since the last reset, and what is still held."""
    print(f"[phase {phase}] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(max_memory_allocated), {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB still allocated", flush=True)


def attn_lm_phases(smi, kind):
    """Phases 37-39: gemma3-12b at full width and depth (f32 decode held
    to one forward across the ring's wrap and the prefill's roll; bf16
    prefill, and greedy generation eager and from the decode graph), then
    the six attention archs card against CPU at the reduced f32 size. The
    attention path runs no kernel of the port's: each wrapper's count
    must stay 0. Every tensor is freed on return."""
    from repro_torch.configs import reduce_config
    from repro_torch.configs.gemma3_12b import CONFIG as GEMMA3_12B
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.cowclip import (fused_cowclip_adam,
                                             sparse_gather_catchup,
                                             sparse_update_scatter)
    from repro_torch.kernels.embedding import embedding_backward_groups
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.launch.train import build_parser
    from repro_torch.models import lm
    from repro_torch.train.loop import train_lm

    power = smi.strip().split(", ")[-1]
    wrappers = (fused_cowclip_adam, sparse_gather_catchup,
                sparse_update_scatter, wkv6, embedding_backward_groups)
    for fn in wrappers:
        fn.launches = 0

    # -- 37. gemma3-12b, full width and depth: f32 decode vs forward -----
    phase_start(37)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = GEMMA3_12B
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
           cfg.d_ff, cfg.vocab_size, cfg.window, cfg.rope_theta,
           cfg.compute_dtype)
          == (48, 3840, 16, 8, 256, 15360, 262144, 1024, 1e6, "bfloat16")
          and cfg.block_pattern == ("local",) * 5 + ("attn",),
          "not the gemma3-12b width")
    n_params = lm.param_counts(cfg)["total"]
    check(n_params == GEMMA3_12B_PARAMS, f"{n_params} parameters")
    print(f"[attn-lm] before gemma3-12b: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
          f"(rwkv6-7b's params freed)", flush=True)
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    drawn = sum(t.numel() for t in tree_leaves(params))
    check(drawn == n_params, f"{drawn} parameters drawn, expected "
          f"{n_params}")
    n_local = cfg.n_repeats * cfg.block_pattern.count("local")
    print(f"[attn-lm] gemma3-12b: {n_params} parameters (f32, "
          f"{4 * n_params / 1e9:.2f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; {n_local} local layers (ring "
          f"of {cfg.window}) + {cfg.n_layers - n_local} attn layers, "
          f"head_dim {cfg.hd}", flush=True)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    for prompt_len, steps in ATTN_TEACHER:
        total = prompt_len + steps
        gap, fwd_s, pre_s, dec_s, cache = teacher_forced(
            params, f32, lm_tokens(cfg, 2, total, seed=prompt_len),
            prompt_len)
        ring = cache["pos_0"].k.shape[2]
        check(ring == cfg.window and cache["pos_5"].k.shape[2] == total,
              f"caches of {ring} / {cache['pos_5'].k.shape[2]} slots")
        what = (f"crosses the ring's wrap at {ring}"
                if prompt_len < ring < total
                else f"the prefill rolls the last {ring} of {prompt_len} "
                     "tokens into the ring")
        print(f"[attn-lm] f32, batch 2, {prompt_len}-token prompt + {steps} "
              f"teacher-forced decode steps ({what}): logits at positions "
              f"{prompt_len - 1}-{total - 1} vs one forward over {total} "
              f"tokens max_abs {gap:.3e} (bar {ATTN_DECODE_BAR}); forward "
              f"{fwd_s:.2f} s, cached prefill {pre_s:.2f} s, "
              f"{dec_s * 1e3 / steps:.1f} ms a decode step, {kind} at "
              f"{power}", flush=True)
        check(gap <= ATTN_DECODE_BAR,
              f"f32 decode differs from the forward by {gap}")
        del cache
    peak_line(37)
    print(f"[phase 37] {time.perf_counter() - t_phase:.1f} s", flush=True)
    phase_end()

    # -- 38. bf16 compute: score-only prefill, greedy generation ---------
    phase_start(38)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    score_prefill("gemma3-12b", params, cfg, ATTN_GROUPS, power, kind)
    graph = generation_phase("gemma3-12b", params, cfg, ATTN_GROUPS, power,
                             kind)
    print(f"[lm-serve] gemma3-12b KV caches: {n_local} rings of "
          f"{cfg.window} + {cfg.n_layers - n_local} linear of "
          f"{ATTN_GEN_PROMPT + ATTN_GEN_NEW} slots, bf16", flush=True)
    launched = [fn.launches for fn in wrappers]
    print(f"[attn-lm] the port's kernels launched {launched} times in "
          f"phases 37-38 (none on the attention path)", flush=True)
    check(not any(launched), f"kernels launched {launched} times")
    del graph, params
    peak_line(38)
    print(f"[phase 38] {time.perf_counter() - t_phase:.1f} s", flush=True)
    phase_end()

    # -- 39. the six attention archs, card vs CPU, reduced f32 -----------
    phase_start(39)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cases = [(arch, reduce_config(get_config(arch))) for arch in ATTN_ARCHS]
    cases.append(("deepseek-coder-33b, pad_attn_heads 8", dataclasses.replace(
        cases[2][1], pad_attn_heads=8)))
    for tag, small in cases:
        agree_reduced(tag, small, seq=12)
    peak_line(39)
    print(f"[phase 39] {time.perf_counter() - t_phase:.1f} s", flush=True)


def lm_tokens(cfg, batch, length, seed):
    """[batch, length] int32 tokens on the card from the port's seeded
    generator (``data.make_lm_tokens``)."""
    from repro_torch.data import make_lm_tokens

    return torch.as_tensor(make_lm_tokens(
        batch * length, cfg.vocab_size, seed=seed).reshape(batch, length),
        device="cuda")


def teacher_forced(params, cfg, tokens, prompt_len):
    """A cached prefill of ``tokens[:, :prompt_len]``, then the rest fed
    as teacher-forced decode steps, held to one forward over all of
    ``tokens``: (max abs logits gap, forward s, prefill s, decode s, the
    cache after the steps)."""
    from repro_torch.models import lm

    total = tokens.shape[1]
    steps = total - prompt_len
    t0 = time.perf_counter()
    with torch.inference_mode():
        full, _ = lm.forward(params, cfg, tokens)
        want = full[:, prompt_len - 1:].clone()
        del full
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        last, cache, cur = lm.prefill_with_cache(params, cfg,
                                                 tokens[:, :prompt_len],
                                                 total)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        check(cur == prompt_len, f"cur_index {cur}")
        outs = [last]
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache = lm.decode_step(params, cfg,
                                           tokens[:, prompt_len + i], cache,
                                           cur + i, inplace=True)
            outs.append(logits)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        got = torch.stack(outs, dim=1)
    check(bool(torch.isfinite(got).all()), "non-finite f32 logits")
    return (got - want).abs().max().item(), fwd_s, pre_s, dec_s, cache


def score_prefill(tag, params, cfg, groups, power, kind):
    """bf16 score-only prefill of ``ATTN_PREFILL``: the first call, the
    mean of ``LM_REPEATS`` more, and a traced one (device time by kernel,
    idle share)."""
    from repro_torch.models import lm

    b, s = ATTN_PREFILL
    prompt = lm_tokens(cfg, b, s, seed=5)

    def prefill():
        with torch.inference_mode():
            out = lm.prefill(params, cfg, prompt)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    last = prefill()
    first_s = time.perf_counter() - t0
    check(tuple(last.shape) == (b, cfg.padded_vocab)
          and bool(torch.isfinite(last).all()), f"{tag}: bf16 prefill not "
          "finite")
    t0 = time.perf_counter()
    for _ in range(LM_REPEATS):
        prefill()
    ms = (time.perf_counter() - t0) * 1e3 / LM_REPEATS
    print(f"[lm-serve] {tag} bf16 score-only prefill {list(ATTN_PREFILL)}"
          f": {ms:.1f} ms ({b * s / ms * 1e3:.0f} tokens/s; first call "
          f"{first_s * 1e3:.1f} ms), mean of {LM_REPEATS}, {kind} at "
          f"{power}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB", flush=True)
    print_trace("lm-trace", f"{tag} bf16 prefill {list(ATTN_PREFILL)}",
                *device_time_by_kernel(prefill), groups=groups)


def op_kernels(prof, op):
    """The kernel names launched under ``op`` (an aten op's name) in a
    profile, less those some other op also launches."""
    mine, others = set(), set()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        up, under = e, False
        while up is not None and not under:
            under, up = up.name == op, up.cpu_parent
        (mine if under else others).update(k.name for k in e.kernels)
    return tuple(sorted(mine - others))


def generation_phase(tag, params, cfg, groups, power, kind, op_group=None):
    """bf16 greedy generation of ``ATTN_GEN_BATCH`` x ``ATTN_GEN_PROMPT``
    tokens + ``ATTN_GEN_NEW``, eager and from the decode graph: the same
    tokens, logits within ``LM_AGREE``; ms a decoded token each way, the
    capture's seconds; then a traced replay (device time by group, no
    host read of a device scalar) and a traced eager step (with
    ``op_group``, (label, aten op): the kernels only that op launches
    there, which are then also a group of the replay's). Returns the
    decode graph."""
    from repro_torch.models import lm
    from repro_torch.serve.decode import GraphDecoder, greedy_generate

    gen_prompt = lm_tokens(cfg, ATTN_GEN_BATCH, ATTN_GEN_PROMPT, seed=6)
    max_len = ATTN_GEN_PROMPT + ATTN_GEN_NEW
    t0 = time.perf_counter()
    decoder = GraphDecoder(params, cfg)
    graph = decoder.graph(ATTN_GEN_BATCH, max_len)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    timing, gens = {}, {}
    for mode in ("eager", "graph"):
        for new in (0, ATTN_GEN_NEW):
            t0 = time.perf_counter()
            gens[mode] = greedy_generate(params, cfg, gen_prompt, new,
                                         decoder=decoder,
                                         graph=mode == "graph")
            torch.cuda.synchronize()
            timing[mode, new] = time.perf_counter() - t0
    res = gens["eager"]
    check(tuple(res.tokens.shape) == (ATTN_GEN_BATCH, ATTN_GEN_NEW)
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all())
          and bool(torch.isfinite(res.logits).all()),
          f"{tag}: bad tokens or non-finite logits")
    decode_ms = {mode: (timing[mode, ATTN_GEN_NEW] - timing[mode, 0]) * 1e3
                 / ATTN_GEN_NEW for mode in ("eager", "graph")}
    same = torch.equal(gens["graph"].tokens, res.tokens)
    gap = (gens["graph"].logits - res.logits).abs().max().item()
    bitwise = torch.equal(gens["graph"].logits, res.logits)
    print(f"[lm-serve] {tag} bf16 greedy generation, {ATTN_GEN_BATCH} x "
          f"{ATTN_GEN_PROMPT}-token prompts + {ATTN_GEN_NEW} tokens: cached "
          f"prefill {timing['eager', 0] * 1e3:.1f} ms; eager "
          f"{decode_ms['eager']:.2f} ms per decoded token "
          f"({ATTN_GEN_BATCH * 1e3 / decode_ms['eager']:.0f} tokens/s), "
          f"graph {decode_ms['graph']:.2f} ms "
          f"({ATTN_GEN_BATCH * 1e3 / decode_ms['graph']:.0f} tokens/s; "
          f"captured once for ({ATTN_GEN_BATCH}, {max_len}) in "
          f"{capture_s:.2f} s with its warm-up step); graph tokens "
          f"{'equal to' if same else 'DIFFER from'} the eager ones, last "
          f"logits max_abs {gap:.3e} (bar {LM_AGREE}), "
          f"{'bitwise' if bitwise else 'not bitwise'}; decode state "
          f"{kv_bytes(graph.cache)} B; cursor {int(graph.cursor)}; first "
          f"tokens {res.tokens[0, :8].tolist()}; {kind} at {power}",
          flush=True)
    check(same and gap <= LM_AGREE
          and list(decoder.graphs) == [(ATTN_GEN_BATCH, max_len)]
          and int(graph.cursor) == max_len,
          f"{tag}: the decode graph's generation differs from the eager one")

    with torch.inference_mode():
        first, cache, cur = lm.prefill_with_cache(params, cfg, gen_prompt,
                                                  max_len)

    def eager_step():
        with torch.inference_mode():
            lm.decode_step(params, cfg, first.argmax(-1), cache, cur,
                           inplace=True)

    wall_ms, prof = profiled(eager_step)
    op_names = op_kernels(prof, op_group[1]) if op_group else ()
    if op_group:
        groups = groups + ((op_group[0], op_names),)
        print(f"[lm-trace] {tag}: {len(op_names)} kernels launched only "
              f"under {op_group[1]} in the eager step: {list(op_names)}")
    print_trace("lm-trace", f"{tag} bf16 eager decode step, batch "
                f"{ATTN_GEN_BATCH}, position {cur}", wall_ms, by_kernel(prof),
                groups=groups)
    graph.start(first.argmax(-1), cache, cur)
    wall_ms, prof = profiled(graph.step, with_stack=True)
    print_trace("lm-trace", f"{tag} bf16 decode step as a graph replay, "
                f"batch {ATTN_GEN_BATCH}, position {cur}", wall_ms,
                by_kernel(prof), groups=groups)
    reads = host_reads(prof)
    n_dev = sum(r[1] == "device" for r in reads)
    print(f"[lm-trace] {tag}: the traced replay made {len(reads)} host "
          f"reads ({HOST_READ}), {n_dev} of a device scalar", flush=True)
    check(not n_dev, f"{tag}: host reads of a device scalar in a replay: "
          f"{reads}")
    return graph


def agree_reduced(tag, small, seq):
    """``small`` (a reduced f32 config) on the card against the CPU from
    the same params: forward logits and MoE aux, the cached prefill and 4
    decode steps, max abs, each within ``LM_AGREE``."""
    from repro_torch.core.tree import tree_map
    from repro_torch.data import make_lm_tokens
    from repro_torch.models import lm
    from repro_torch.serve.decode import frontend_prefix

    params0 = lm.init(small, seed=0, device="cpu")
    tokens = torch.as_tensor(make_lm_tokens(
        2 * (seq + 4), small.vocab_size, seed=7).reshape(2, seq + 4))
    prefix = frontend_prefix(small, 2, seed=8, device="cpu")
    p = 0 if prefix is None else prefix.shape[1]
    runs = {}
    for dev in ("cpu", "cuda"):
        prm = tree_map(lambda t: t.to(dev), params0)
        pre = None if prefix is None else prefix.to(dev)
        with torch.inference_mode():
            logits, aux = lm.forward(prm, small, tokens[:, :seq].to(dev), pre)
            last, cache, cur = lm.prefill_with_cache(
                prm, small, tokens[:, :seq].to(dev), p + seq + 4, pre)
            outs = [logits, aux, last]
            for i in range(4):
                last, cache = lm.decode_step(
                    prm, small, tokens[:, seq + i].to(dev), cache, cur + i,
                    inplace=True)
                outs.append(last)
        runs[dev] = [t.cpu() for t in outs]
    gaps = [(a - c).abs().max().item()
            for a, c in zip(runs["cuda"], runs["cpu"])]
    aux = runs["cuda"][1].item()
    ring = (f", shared rings of {small.window} under a {seq}-token prompt"
            if small.shared_attn else "")
    moe = (f", {small.moe.n_experts} experts top {small.moe.top_k}, aux "
           f"{aux:.6f}" if small.moe else "")
    print(f"[lm-agree] reduced {tag} ({small.block_pattern}, kv "
          f"{small.n_kv_heads}, alloc {small.n_heads_alloc}, act "
          f"{small.act}, prefix {p}{ring}{moe}), {seq} tokens, card vs CPU "
          f"max_abs: forward {gaps[0]:.3e}, aux {gaps[1]:.3e}, cached "
          f"prefill {gaps[2]:.3e}, 4 decode steps {max(gaps[3:]):.3e} (bar "
          f"{LM_AGREE})", flush=True)
    check(max(gaps) <= LM_AGREE, f"card and CPU disagree on {tag}")


def count_drops(moe_lib, tally):
    """``moe_lib.moe_ffn`` wrapped to add, on the card, each call's
    token-slots (groups x tokens x top_k) and those its capacity drops
    (each expert's choices past the capacity, per group) to ``tally``."""
    inner = moe_lib.moe_ffn

    def moe_ffn(params, x, cfg, act="swiglu"):
        probs = torch.softmax(
            (x @ params["router"].to(x.dtype)).to(torch.float32), dim=-1)
        top_e = torch.topk(probs, cfg.top_k, dim=-1).indices
        counts = moe_lib._expert_counts(top_e.reshape(x.shape[0], -1),
                                        cfg.n_experts)
        cap = moe_lib.capacity(x.shape[1], cfg)
        tally["dropped"] += (counts - cap).clamp(min=0).sum()
        tally["slots"] += top_e.numel()
        return inner(params, x, cfg, act)

    return moe_ffn


def hybrid_lm_phases(smi, kind):
    """Phases 40-43: zamba2-2.7b at full width and depth (f32 decode held
    to one forward; bf16 prefill and greedy generation eager and from the
    decode graph), granite-moe-3b-a800m the same way (f32 at capacity
    factor 5.0, the drop share at 1.25), then zamba2, granite-moe and
    llama4-scout card against CPU at the reduced f32 size. The Mamba-2,
    shared-attention and MoE paths run no kernel of the port's: each
    wrapper's count must stay 0. Every tensor is freed on return."""
    from repro_torch.configs import reduce_config
    from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.zamba2_2_7b import CONFIG as ZAMBA2
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.cowclip import (fused_cowclip_adam,
                                             sparse_gather_catchup,
                                             sparse_update_scatter)
    from repro_torch.kernels.embedding import embedding_backward_groups
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_lib

    power = smi.strip().split(", ")[-1]
    wrappers = (fused_cowclip_adam, sparse_gather_catchup,
                sparse_update_scatter, wkv6, embedding_backward_groups)
    for fn in wrappers:
        fn.launches = 0
    prompt_len, steps = HYBRID_TEACHER

    # -- 40. zamba2-2.7b, full width and depth: f32 decode vs forward ----
    phase_start(40)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = ZAMBA2
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
           cfg.d_ff, cfg.ssm_state, cfg.mamba_head_dim, cfg.window,
           cfg.n_repeats, cfg.shared_attn, cfg.vocab_size)
          == (54, 2560, 32, 32, 80, 10240, 64, 64, 4096, 9, True, 32000)
          and cfg.block_pattern == ("mamba2",) * 6,
          "not the zamba2-2.7b width")
    n_params = lm.param_counts(cfg)["total"]
    check(n_params == ZAMBA2_PARAMS, f"{n_params} parameters")
    print(f"[hybrid-lm] before zamba2-2.7b: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
          f"(gemma3-12b's params freed)", flush=True)
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    drawn = sum(t.numel() for t in tree_leaves(params))
    check(drawn == n_params, f"{drawn} parameters drawn, expected "
          f"{n_params}")
    print(f"[hybrid-lm] zamba2-2.7b: {n_params} parameters (f32, "
          f"{4 * n_params / 1e9:.2f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; {cfg.n_layers} Mamba-2 layers "
          f"(state {cfg.ssm_state}, head_dim {cfg.mamba_head_dim}), the "
          f"shared block after every {len(cfg.block_pattern)} "
          f"({cfg.n_repeats} invocations, ring of {cfg.window})",
          flush=True)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    tokens = lm_tokens(cfg, 2, prompt_len + steps, seed=prompt_len)
    gap, fwd_s, pre_s, dec_s, _ = teacher_forced(params, f32, tokens,
                                                 prompt_len)
    print(f"[hybrid-lm] zamba2-2.7b f32, batch 2, {prompt_len}-token prompt "
          f"+ {steps} teacher-forced decode steps: logits at positions "
          f"{prompt_len - 1}-{prompt_len + steps - 1} vs one forward over "
          f"{prompt_len + steps} tokens max_abs {gap:.3e} (bar "
          f"{ATTN_DECODE_BAR}); forward {fwd_s:.2f} s, cached prefill "
          f"{pre_s:.2f} s, {dec_s * 1e3 / steps:.1f} ms a decode step, "
          f"{kind} at {power}", flush=True)
    check(gap <= ATTN_DECODE_BAR,
          f"zamba2 f32 decode differs from the forward by {gap}")

    def cached_prefill():
        with torch.inference_mode():
            lm.prefill_with_cache(params, f32, tokens[:, :prompt_len],
                                  prompt_len + steps)
        torch.cuda.synchronize()

    wall_ms, prof = profiled(cached_prefill)
    kernels = by_kernel(prof)
    print(f"[hybrid-lm] zamba2-2.7b f32 cached prefill of 2 x {prompt_len}: "
          f"{sum(n for _, n, _ in kernels)} kernel launches (the profiler's "
          f"count), {wall_ms:.1f} ms traced", flush=True)
    print_trace("hybrid-trace", f"zamba2-2.7b f32 cached prefill 2 x "
                f"{prompt_len}", wall_ms, kernels, groups=HYBRID_GROUPS)
    del tokens, prof, kernels
    peak_line(40)
    print(f"[phase 40] {time.perf_counter() - t_phase:.1f} s", flush=True)
    phase_end()

    # -- 41. zamba2-2.7b in bf16: prefill, greedy generation -------------
    phase_start(41)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    score_prefill("zamba2-2.7b", params, cfg, HYBRID_GROUPS, power, kind)
    graph = generation_phase("zamba2-2.7b", params, cfg, HYBRID_GROUPS,
                             power, kind)
    mixers = [graph.cache[f"pos_{i}"] for i in range(len(cfg.block_pattern))]
    parts = {"shared rings": kv_bytes(graph.cache["shared"]),
             "SSM states": sum(kv_bytes(m.s) for m in mixers),
             "conv tails": sum(kv_bytes(m.conv) for m in mixers)}
    print(f"[hybrid-lm] zamba2-2.7b decode state at batch {ATTN_GEN_BATCH}, "
          f"max_len {ATTN_GEN_PROMPT + ATTN_GEN_NEW}, bf16: "
          f"{kv_bytes(graph.cache)} B: {parts}", flush=True)
    check(sum(parts.values()) == kv_bytes(graph.cache),
          "the decode state's parts do not add up")
    del graph, params
    peak_line(41)
    print(f"[phase 41] {time.perf_counter() - t_phase:.1f} s", flush=True)
    phase_end()

    # -- 42. granite-moe-3b-a800m, full width ----------------------------
    phase_start(42)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = GRANITE
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_heads_alloc,
           cfg.n_kv_heads, cfg.moe.n_experts, cfg.moe.top_k, cfg.d_ff,
           cfg.vocab_size, cfg.padded_vocab, cfg.moe.capacity_factor)
          == (32, 1536, 24, 32, 8, 40, 8, 512, 49155, 49408, 1.25),
          "not the granite-moe-3b-a800m width")
    counts = lm.param_counts(cfg)
    check((counts["total"], counts["active"]) == GRANITE_MOE_PARAMS,
          f"{counts} parameters")
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[hybrid-lm] granite-moe-3b-a800m: {counts['total']} parameters "
          f"({counts['active']} active; f32, {4 * counts['total'] / 1e9:.2f}"
          f" GB) drawn on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    f32 = dataclasses.replace(cfg, compute_dtype="float32",
                              moe=dataclasses.replace(
                                  cfg.moe, capacity_factor=MOE_NO_DROP))
    check(moe_lib.capacity(prompt_len + steps, f32.moe) == prompt_len + steps,
          "the capacity is not a group's tokens")
    tokens = lm_tokens(cfg, 2, prompt_len + steps, seed=prompt_len)
    gap, fwd_s, pre_s, dec_s, _ = teacher_forced(params, f32, tokens,
                                                 prompt_len)
    print(f"[hybrid-lm] granite-moe-3b-a800m f32 at capacity factor "
          f"{MOE_NO_DROP} (capacity {prompt_len + steps}: no drop), batch 2, "
          f"{prompt_len}-token prompt + {steps} teacher-forced decode steps: "
          f"max_abs {gap:.3e} vs one forward (bar {ATTN_DECODE_BAR}); "
          f"forward {fwd_s:.2f} s, cached prefill {pre_s:.2f} s, "
          f"{dec_s * 1e3 / steps:.1f} ms a decode step, {kind} at {power}",
          flush=True)
    check(gap <= ATTN_DECODE_BAR,
          f"granite-moe f32 decode differs from the forward by {gap}")
    tally = {"dropped": torch.zeros((), dtype=torch.int64, device="cuda"),
             "slots": 0}
    own = dataclasses.replace(f32, moe=cfg.moe)
    inner, moe_lib.moe_ffn = moe_lib.moe_ffn, count_drops(moe_lib, tally)
    try:
        with torch.inference_mode():
            at_own, _ = lm.forward(params, own, tokens)
            ample, _ = lm.forward(params, f32, tokens)
    finally:
        moe_lib.moe_ffn = inner
    dropped = int(tally["dropped"])
    print(f"[hybrid-lm] granite-moe-3b-a800m f32 forward over 2 x "
          f"{prompt_len + steps} at the config's capacity factor "
          f"{cfg.moe.capacity_factor} (capacity "
          f"{moe_lib.capacity(prompt_len + steps, cfg.moe)}): {dropped} of "
          f"{tally['slots']} token-slots dropped "
          f"({100 * dropped / tally['slots']:.2f}%; at {MOE_NO_DROP} none); "
          f"its logits vs {MOE_NO_DROP}'s max_abs "
          f"{(at_own - ample).abs().max().item():.3e}", flush=True)
    del tokens, at_own, ample
    score_prefill("granite-moe-3b-a800m", params, cfg, HYBRID_GROUPS, power,
                  kind)
    graph = generation_phase("granite-moe-3b-a800m", params, cfg,
                             HYBRID_GROUPS, power, kind,
                             op_group=("expert einsums", "aten::einsum"))
    del graph, params
    launched = [fn.launches for fn in wrappers]
    print(f"[hybrid-lm] the port's kernels launched {launched} times in "
          f"phases 40-42 (none on the Mamba-2, shared-attention and MoE "
          f"paths)", flush=True)
    check(not any(launched), f"kernels launched {launched} times")
    peak_line(42)
    print(f"[phase 42] {time.perf_counter() - t_phase:.1f} s", flush=True)
    phase_end()

    # -- 43. the three archs, card vs CPU, reduced f32 -------------------
    phase_start(43)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    for arch in HYBRID_ARCHS:
        agree_reduced(arch, reduce_config(get_config(arch)), seq=12)
    launched = [fn.launches for fn in wrappers]
    check(not any(launched), f"kernels launched {launched} times")
    peak_line(43)
    print(f"[phase 43] {time.perf_counter() - t_phase:.1f} s", flush=True)


def lm_cowclip_phase(gen, tokens, power, kind):
    """Phase 44: the fused CowClip update of the token table at
    ``LM_TRAIN_TABLE`` with ``tokens``' counts against its plain version
    (phase 3's rtol / atol), steps 1 and 1000, then timed (L2 flushed,
    host work covered) beside its bound. Returns the line's numbers."""
    from repro_torch.kernels.cowclip import (fused_cowclip_adam, reference,
                                             step_scalars)
    from repro_torch.models.embedding import token_counts

    rows, dim = LM_TRAIN_TABLE
    cnt = token_counts(tokens, rows)
    step_kw = dict(r=1.0, zeta=1e-5, lr=2e-2, l2=1e-5)
    err = [0.0]
    w, g, cnt, m, v = kernel_inputs(gen, rows, dim, cnt=cnt)
    for t in (1, 1000):
        block = step_scalars(t, device="cuda")
        want = reference(w, g, cnt, m, v, block, **step_kw)
        got = [x.clone() for x in (w, m, v)]
        fused_cowclip_adam(got[0], g, cnt, got[1], got[2], block, **step_kw)
        torch.cuda.synchronize()
        for name, a, b in zip("wmv", got, want):
            compare("lm-cowclip", f"[{rows}, {dim}] step {t}, {name} "
                    f"({int((cnt > 0).sum())} rows touched by "
                    f"{tokens.numel()} tokens)", a, b, err)
        del want, got
    torch.cuda.empty_cache()
    scratch = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    block = step_scalars(5, device="cuda")
    ms = cuda_time_cold_ms(lambda: fused_cowclip_adam(
        w, g, cnt, m, v, block, **step_kw), 20, scratch)
    plain_ms = cuda_time_cold_ms(lambda: reference(
        w, g, cnt, m, v, block, **step_kw), 3, scratch)
    bound_ms, bound_by, touched, nbytes = update_bound(cnt, dim)
    print(f"[time] fused CowClip [{rows}, {dim}], one {tokens.shape[0]} x "
          f"{tokens.shape[1]} batch's counts ({touched} rows touched, L2 "
          f"flushed): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s: {100 * bound_ms / ms:.1f}% of "
          f"it), {kind} at {power}", flush=True)
    del w, g, cnt, m, v, scratch
    return {"max_abs_err_lm_train": err[0], "ms_lm_train": ms,
            "plain_ms_lm_train": plain_ms, "bound_ms_lm_train": bound_ms,
            "bound_by_lm_train": bound_by, "library_ms_lm_train": None}


def lm_embed_phase(gen, tokens, power, kind):
    """Phase 45: the token table's gradient, the embedding backward of
    ``tokens``' rows of width D into ``LM_TRAIN_TABLE``'s rows, bitwise
    its plain version and run to run; timed (its sort included) beside
    its bound and PyTorch's ``embedding_dense_backward``."""
    from repro_torch.kernels.embedding import (embedding_backward,
                                               reference_groups, sort_plan)

    rows, dim = LM_TRAIN_TABLE
    keys = tokens.reshape(-1).to(torch.int32)
    n = keys.numel()
    cot = 1e-3 * torch.randn(n, dim, generator=gen, device="cuda")
    got = embedding_backward(keys, cot, rows)
    again = embedding_backward(keys, cot, rows)
    want = reference_groups(sort_plan(keys), [cot], rows)[0]
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    same, repeat = torch.equal(got, want), torch.equal(got, again)
    print(f"[lm-embed] {n} token rows of width {dim} into [{rows}, {dim}]: "
          f"against the plain version max_abs {err:.3e}, "
          f"{'bitwise equal' if same else 'DIFFERENT'}; run twice "
          f"{'bitwise equal' if repeat else 'DIFFERENT'}", flush=True)
    check(same and repeat, "the embedding backward at the token table's "
          "width is not bitwise its plain version, or not run to run")
    del got, again, want
    scratch = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    ms = cuda_time_cold_ms(lambda: embedding_backward(keys, cot, rows), 20,
                           scratch)
    plain_ms = cuda_time_cold_ms(lambda: reference_groups(
        sort_plan(keys), [cot], rows), 3, scratch)
    lib_ms = cuda_time_cold_ms(lambda: torch.ops.aten.embedding_dense_backward(
        cot, keys, rows, -1, False), 20, scratch)
    bound_ms, bound_by, nbytes = embed_bound(n, (dim,), rows)
    print(f"[time] embedding backward, {n} rows of width {dim} into "
          f"[{rows}, {dim}] (sort, fill, levels; L2 flushed): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, PyTorch's "
          f"embedding_dense_backward {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"by {bound_by} ({nbytes} B: {100 * bound_ms / ms:.1f}% of it), "
          f"{kind} at {power}", flush=True)
    del cot, scratch
    return {"max_abs_err_lm_train": err, "ms_lm_train": ms,
            "plain_ms_lm_train": plain_ms, "bound_ms_lm_train": bound_ms,
            "bound_by_lm_train": bound_by, "library_ms_lm_train": lib_ms}


def lm_wkv_phase(gen, power, kind):
    """Phase 46: wkv6 under autograd at ``LM_TRAIN_WKV``: the forward (the
    kernel) at the wkv6 bar against the chunked plain version, the
    gradients of r, k, v, w and u (the plain version's backward,
    recomputed) bitwise the plain version's own autograd; times of the
    kernel, the plain forward and the plain backward, and the backward's
    memory above its inputs. Returns the line's numbers and the
    backward's ms."""
    from repro_torch.kernels.wkv6 import chunked_wkv6_reference, wkv6

    inp = wkv_inputs(gen, *LM_TRAIN_WKV)
    gy = torch.randn(inp[0].shape, generator=gen, device="cuda")
    outs, grads = {}, {}
    for name, fn in (("kernel", wkv6), ("plain", chunked_wkv6_reference)):
        ins = [t.clone().requires_grad_() for t in inp]
        y, s = fn(*ins)
        outs[name] = (y.detach(), s.detach())
        grads[name] = torch.autograd.grad(y, ins, gy)
        del y, s, ins
    err = [0.0]
    wkv_compare(f"{list(LM_TRAIN_WKV)} under autograd, forward vs chunked "
                f"plain", outs["kernel"], outs["plain"], err)
    gaps = [(a - b).abs().max().item()
            for a, b in zip(grads["kernel"], grads["plain"])]
    same = all(torch.equal(a, b)
               for a, b in zip(grads["kernel"], grads["plain"]))
    print(f"[wkv6] {list(LM_TRAIN_WKV)} gradients of r, k, v, w, u through "
          f"the wrapper (kernel forward, plain backward) against the plain "
          f"version's autograd: max_abs {max(gaps):.3e}, "
          f"{'bitwise equal' if same else 'DIFFERENT'}", flush=True)
    check(same, "wkv6's gradients are not the plain version's")
    del outs, grads
    torch.cuda.empty_cache()
    scratch = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    with torch.no_grad():
        k_ms = cuda_time_cold_ms(lambda: wkv6(*inp), 20, scratch)
        p_ms = cuda_time_cold_ms(lambda: chunked_wkv6_reference(*inp), 3,
                                 scratch)
    ins = [t.clone().requires_grad_() for t in inp]
    y, _ = wkv6(*ins)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bwd_ms = cuda_time_cold_ms(lambda: torch.autograd.grad(
        y, ins, gy, retain_graph=True), 5, scratch)
    bwd_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    b_ms, b_by, nbytes, flops = wkv_bound(*LM_TRAIN_WKV)
    print(f"[time] chunked_wkv6 {list(LM_TRAIN_WKV)} (L2 flushed): kernel "
          f"{k_ms:.4f} ms, plain forward {p_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"by {b_by} ({nbytes} B, {flops} FLOP); the plain backward "
          f"(recompute and autograd) {bwd_ms:.4f} ms, {bwd_gib:.2f} GiB "
          f"above its inputs at its peak; {kind} at {power}", flush=True)
    del inp, ins, y, gy, scratch
    return ({"max_abs_err_lm_train": err[0], "ms_lm_train": k_ms,
             "plain_ms_lm_train": p_ms, "bound_ms_lm_train": b_ms,
             "bound_by_lm_train": b_by, "library_ms_lm_train": None},
            bwd_ms)


def grad_gaps(want, got):
    """Each gradient leaf's max abs difference over its own largest |g| in
    ``want`` (0 where both are all zero), by path."""
    from repro_torch.core.tree import flatten_with_paths

    want = flatten_with_paths(want)
    out = {}
    for k, g in flatten_with_paths(got).items():
        w = want[k].double()
        err = (g.cpu().double() - w).abs().max().item()
        scale = w.abs().max().item()
        out[k] = err / scale if scale else (0.0 if not err else math.inf)
    return out


def lm_step_agree(arch):
    """Phase 47, one family (and ``tests/test_torch_cuda.py``):
    ``LM_AGREE_STEPS`` steps of ``make_lm_train_step`` at the reduced f32
    size on the card against the CPU, along the card's trajectory: at each
    step, from the card's params, the loss within ``LM_AGREE`` and every
    gradient leaf within ``LM_GRAD_BAR`` (rwkv6: ``LM_GRAD_BAR_RWKV6``) of
    its own largest value; the step launches the fused CowClip kernel
    once, the embedding backward once and wkv6 once a rwkv6 layer; the
    CPU's update of the card's gradients tracked beside it, every param
    within ``LM_AGREE`` after the steps. Returns the largest gaps."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.scaling import scale_hyperparams
    from repro_torch.core.tree import flatten_with_paths, tree_map
    from repro_torch.kernels.cowclip import fused_cowclip_adam
    from repro_torch.kernels.embedding import embedding_backward_groups
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.models import lm
    from repro_torch.serve.decode import frontend_prefix
    from repro_torch.train import loop

    cfg = dataclasses.replace(reduce_config(get_config(arch)),
                              wkv_backend="chunked")
    bar = LM_GRAD_BAR_RWKV6 if "rwkv6" in cfg.block_pattern else LM_GRAD_BAR
    hp = scale_hyperparams("cowclip", base_lr=2e-2, base_l2=1e-5,
                           base_batch=1024, batch_size=1024,
                           base_dense_lr=4e-2)
    step, init = loop.make_lm_train_step(cfg, hp)
    cpu_update = loop.make_lm_update(cfg, hp)[0]
    cpu = lm.init(cfg, seed=0, device="cpu")
    card = tree_map(lambda t: t.cuda(), cpu)
    cpu_state, state = init(cpu), init(card)
    counters = (fused_cowclip_adam, embedding_backward_groups, wkv6)
    want_calls = (1, 1, cfg.n_layers if "rwkv6" in cfg.block_pattern else 0)
    rng = np.random.default_rng(47)
    gap_loss, gaps = 0.0, {}
    for i in range(LM_AGREE_STEPS):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)))
        prefix = frontend_prefix(cfg, 4, seed=i, device="cpu")
        here = tree_map(lambda t: t.cpu(), card)
        want_loss, want = loop._grads(here, lambda v: lm.loss_fn(
            v, cfg, tokens, prefix)[0])
        loss, grads = loop._grads(card, lambda v: lm.loss_fn(
            v, cfg, tokens.cuda(), None if prefix is None else prefix.cuda()
        )[0])
        gap_loss = max(gap_loss, abs(loss.item() - want_loss.item()))
        for k, gap in grad_gaps(want, grads).items():
            gaps[k] = max(gaps.get(k, 0.0), gap)
        cpu_update(cpu, cpu_state, tree_map(lambda t: t.cpu(), grads),
                   tokens)
        before = [fn.launches for fn in counters]
        card, state, aux = step(card, state, {
            "tokens": tokens.cuda(),
            "prefix": None if prefix is None else prefix.cuda()})
        calls = tuple(fn.launches - b for fn, b in zip(counters, before))
        check(calls == want_calls, f"{arch}: a step launched {calls} "
              f"(fused CowClip, embedding backward, wkv6), not {want_calls}")
        check(torch.equal(aux["loss"], loss), f"{arch}: the step's loss is "
              f"not its gradient's")
    cpu_flat = flatten_with_paths(cpu)
    gap_param = max((t.cpu() - cpu_flat[k]).abs().max().item()
                    for k, t in flatten_with_paths(card).items())
    worst = max(gaps, key=gaps.get)
    print(f"[lm-train-agree] reduced {arch} ({cfg.block_pattern}), "
          f"{LM_AGREE_STEPS} steps of batch 4 x 32, card vs CPU: loss "
          f"max_abs {gap_loss:.3e} (bar {LM_AGREE}); gradients max_abs over "
          f"the leaf's max |g| {gaps[worst]:.3e} in {worst} (bar {bar}), "
          f"next {sorted(gaps.values())[-3:-1]}; params after the CPU's "
          f"update of the card's gradients max_abs {gap_param:.3e} (bar "
          f"{LM_AGREE})", flush=True)
    check(gap_loss <= LM_AGREE and gaps[worst] <= bar
          and gap_param <= LM_AGREE, f"card and CPU disagree on {arch}'s "
          f"train step")
    return gap_loss, gaps[worst], gap_param


def lm_cli_on_card():
    """Phase 47: ``python -m repro_torch.launch.train`` with
    ``LM_CLI_ARGS`` and a checkpoint, on the card (its default device):
    each step launches the fused CowClip kernel once, the embedding
    backward once and wkv6 once a layer; the loss falls (the CLI's own
    check) and the checkpoint holds every param leaf at its shape."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.tree import flatten_with_paths
    from repro_torch.kernels.cowclip import fused_cowclip_adam
    from repro_torch.kernels.embedding import embedding_backward_groups
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.launch import train as cli
    from repro_torch.models import lm

    cfg = reduce_config(get_config("rwkv6-7b"))
    steps = int(LM_CLI_ARGS[LM_CLI_ARGS.index("--steps") + 1])
    counters = (fused_cowclip_adam, embedding_backward_groups, wkv6)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "lm.npz")
        for fn in counters:
            fn.launches = 0
        cli.main(list(LM_CLI_ARGS) + ["--checkpoint", ckpt])
        calls = {fn.__name__: fn.launches for fn in counters}
        with np.load(ckpt) as saved:
            shapes = {k: saved[k].shape for k in saved.files}
    want = {k: tuple(t.shape) for k, t in flatten_with_paths(
        lm.init(cfg, seed=0, device="cpu")).items()}
    print(f"[lm-train-cli] {' '.join(LM_CLI_ARGS)} on the card: wrapper "
          f"calls {calls} (expected 1, 1 and {cfg.n_layers} a step); the "
          f"checkpoint holds {len(shapes)} leaves", flush=True)
    check(calls == {"fused_cowclip_adam": steps,
                    "embedding_backward_groups": steps,
                    "wkv6": cfg.n_layers * steps}, f"the CLI launched {calls}")
    check(shapes == want, "the CLI's checkpoint is not the params' tree")


def lm_train_phases(smi, kind):
    """Phases 44-48: LM training (``--task lm``'s step) at rwkv6-7b's
    width. Returns each kernel's numbers at this path's shapes and its
    launches in phase 48's 10-step run, by kernel name."""
    from repro_torch.configs.rwkv6_7b import CONFIG as RWKV6_7B
    from repro_torch.core.tree import flatten_with_paths
    from repro_torch.data import make_lm_tokens
    from repro_torch.kernels.cowclip import fused_cowclip_adam
    from repro_torch.kernels.embedding import embedding_backward_groups, ref
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.launch.train import build_parser
    from repro_torch.models import lm
    from repro_torch.train.loop import train_lm

    power = smi.strip().split(", ")[-1]
    gen = torch.Generator(device="cuda").manual_seed(44)
    b, s = LM_TRAIN_BATCH
    # the CLI's token stream (``--samples``' default, seed 0): phases 44-45
    # and the traced step take its first batch, phase 48's first step's
    samples = build_parser().get_default("samples")
    first = torch.as_tensor(make_lm_tokens(samples, RWKV6_7B.vocab_size,
                                           seed=0)[:b * s].reshape(b, s),
                            device="cuda")
    lines = {}

    phase_start(44)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    lines["cowclip_adam_update"] = lm_cowclip_phase(gen, first, power,
                                                    kind)
    peak_line(44)
    phase_end()
    phase_start(45)
    torch.cuda.reset_peak_memory_stats()
    lines["embedding_backward"] = lm_embed_phase(gen, first, power,
                                                 kind)
    peak_line(45)
    phase_end()
    phase_start(46)
    torch.cuda.reset_peak_memory_stats()
    lines["chunked_wkv6"], wkv_bwd_ms = lm_wkv_phase(gen, power, kind)
    peak_line(46)
    phase_end()
    phase_start(47)
    for arch in LM_TRAIN_ARCHS:
        lm_step_agree(arch)
    lm_cli_on_card()
    phase_end()
    print(f"[phase 44-47] {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- 48. rwkv6-7b at full width, 8 layers: 10 training steps ---------
    phase_start(48)
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(RWKV6_7B, n_layers=LM_TRAIN_LAYERS,
                              wkv_backend="chunked")
    n_params = lm.param_counts(cfg)["total"]
    check(cfg.d_model == 4096 and cfg.n_heads == 64 and cfg.d_ff == 14336
          and cfg.vocab_size == 65536 and cfg.compute_dtype == "bfloat16"
          and n_params == LM_TRAIN_PARAMS, f"not rwkv6-7b's width at "
          f"{LM_TRAIN_LAYERS} layers: {n_params} parameters")

    def run(steps):    # the CLI's loop at LM_TRAIN_BASE_LR
        return train_lm(cfg, batch=b, seq=s, steps=steps,
                        base_lr=LM_TRAIN_BASE_LR, base_l2=1e-5,
                        samples=samples, seed=0, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    counters = (wkv6, fused_cowclip_adam, embedding_backward_groups)
    for fn in counters:
        fn.launches = 0
    out = run(LM_TRAIN_STEPS)
    launches = {fn.__name__: fn.launches for fn in counters}
    params, state, step = out.params, out.state, out.step
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = out.losses.tolist()
    step_ms = [1e3 * x for x in out.step_seconds]
    steady = sorted(step_ms[2:])[len(step_ms[2:]) // 2]
    print(f"[lm-train] {out.hp} (run_lm's scaling from --base-lr "
          f"{LM_TRAIN_BASE_LR}, --base-l2 1e-5)", flush=True)
    print(f"[lm-train] rwkv6-7b at full width, {LM_TRAIN_LAYERS} of 32 "
          f"layers ({n_params} parameters, f32 masters), bf16, wkv6 chunked, "
          f"batch {b} x {s}: {LM_TRAIN_STEPS} steps, loss {losses[0]:.4f} "
          f"at step 1 -> {losses[-1]:.4f} at step {LM_TRAIN_STEPS}; "
          f"launches {launches} (expected wkv6 {LM_TRAIN_LAYERS}, the fused "
          f"CowClip update 1 and the embedding backward 1 a step)",
          flush=True)
    print(f"[lm-train] ms a step (CUDA events) {[round(x, 1) for x in step_ms]}"
          f"; median of steps 3-{LM_TRAIN_STEPS} {steady:.1f} ms "
          f"({b * s / steady * 1e3:.0f} tokens/s); peak device memory "
          f"{peak:.2f} GiB; {kind} at {power}", flush=True)
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"the loss did not fall: {losses}")
    check(launches == {"wkv6": LM_TRAIN_LAYERS * LM_TRAIN_STEPS,
                       "fused_cowclip_adam": LM_TRAIN_STEPS,
                       "embedding_backward_groups": LM_TRAIN_STEPS},
          f"LM training launched {launches}")

    # a traced step: the kernels, host reads, PyTorch's embedding backward
    def control():    # one read of a device scalar, then of a host one
        float(torch.ones((), device="cuda"))
        float(torch.ones(()))

    kinds = sorted(r[1] for r in host_reads(profiled(control,
                                                      with_stack=True)[1]))
    check(kinds == ["device", "host"], f"host reads classified {kinds}")
    for fn in counters:
        fn.launches = 0

    def traced():
        with torch.profiler.record_function(f"{STEP_LABEL} 0"):
            step(params, state, {"tokens": first, "prefix": None})

    wall_ms, prof = profiled(traced, with_stack=True)
    kernels = by_kernel(prof)
    traced_launches = {fn.__name__: fn.launches for fn in counters}
    busy = sum(t for t, _, _ in kernels)
    print_trace("lm-train-trace", f"one step, batch {b} x {s}", wall_ms,
                kernels, groups=(("the wkv6 scan's kernels", WKV6_KERNELS),
                                 ("the fused CowClip update's kernels",
                                  FUSED_KERNELS), EMBED_GROUP) + ATTN_GROUPS)
    n_kernel = {label: sum(n for _, n, name in kernels
                           if any(k in name for k in names))
                for label, names in (("wkv6", WKV6_KERNELS),
                                     ("fused", FUSED_KERNELS),
                                     ("embed", EMBED_KERNELS))}
    reads = host_reads(prof)
    dev_reads = [r[:4] for r in reads if r[1] == "device"]
    theirs = torch_embedding_backward(kernels)
    print(f"[lm-train-trace] wrapper calls {traced_launches}; kernels "
          f"{n_kernel} (the embedding backward's {ref.levels(b * s)} level "
          f"launches a run); host reads {len(reads)}, {len(dev_reads)} of a "
          f"device scalar; PyTorch's embedding backward kernels {theirs}; "
          f"device idle {100 * (1 - busy / wall_ms) if busy else float('nan'):.1f}"
          f"% of {wall_ms:.1f} ms", flush=True)
    check(traced_launches == {"wkv6": LM_TRAIN_LAYERS,
                              "fused_cowclip_adam": 1,
                              "embedding_backward_groups": 1},
          f"a traced step launched {traced_launches}")
    check(not busy or (n_kernel["wkv6"] == LM_TRAIN_LAYERS
                       and n_kernel["fused"] == 1
                       and n_kernel["embed"] == ref.levels(b * s)),
          f"the traced step's kernels {n_kernel}")
    check(not dev_reads, f"host reads of a device scalar: {dev_reads}")
    check(not theirs, f"PyTorch's embedding backward ran: {theirs}")
    print(f"[lm-train] the plain wkv6 backward {wkv_bwd_ms:.1f} ms a layer "
          f"(phase 46) x {LM_TRAIN_LAYERS} = "
          f"{wkv_bwd_ms * LM_TRAIN_LAYERS:.1f} ms, "
          f"{100 * wkv_bwd_ms * LM_TRAIN_LAYERS / steady:.1f}% of a "
          f"{steady:.1f} ms step", flush=True)
    del params, state, step, out, prof, kernels
    phase_end()

    # two runs of 3 steps from the same seed, bitwise equal
    snapshot = {k: t.cpu() for k, t in
                flatten_with_paths(run(LM_TRAIN_REPEAT).params).items()}
    params = run(LM_TRAIN_REPEAT).params
    diffs = {k: (t.cpu() - snapshot[k]).abs().max().item()
             for k, t in flatten_with_paths(params).items()
             if not torch.equal(t.cpu(), snapshot[k])}
    print(f"[lm-train] two runs of {LM_TRAIN_REPEAT} steps from seed 0: "
          + ("bitwise equal in every param leaf" if not diffs else
             f"DIFFERENT in {len(diffs)} leaves, largest "
             f"{max(diffs.values()):.3e} in {max(diffs, key=diffs.get)}"),
          flush=True)
    check(not diffs, f"two runs of the same steps differ: {diffs}")
    del params, snapshot
    print(f"[phase 48] {time.perf_counter() - t_phase:.1f} s", flush=True)
    launches = {"chunked_wkv6": launches["wkv6"],
                "cowclip_adam_update": launches["fused_cowclip_adam"],
                "embedding_backward": launches["embedding_backward_groups"]}
    for name, line in lines.items():
        line["launches_lm_train"] = launches[name]
    return lines


def main() -> int:
    # a SIGSEGV (or SIGBUS, SIGFPE, SIGABRT) prints every thread's Python
    # stack to stderr before the process dies of it, with its exit code
    faulthandler.enable(all_threads=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    sys.path.insert(0, str(src))
    from repro_torch.kernels.extension import build

    # -- 1. card ---------------------------------------------------------
    phase_start(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # -- 2. build: the five kernels, one extension -----------------------
    phase_start(2)
    t0 = time.perf_counter()
    build()
    print(f"[build] cowclip_adam.cu + sparse_catchup.cu + sparse_update.cu "
          f"+ wkv6.cu + embedding_backward.cu + binding.cpp for sm_90a, one "
          f"extension, in {time.perf_counter() - t0:.1f} s", flush=True)

    lines = ctr_phases(smi, kind)
    phase_end()
    phase_start(24)
    lines.append(embed_phase(smi, kind))
    phase_end()
    hot_calls, guarded_calls, (sharded_calls, hybrid_calls), \
        sharded_guarded = graph_phases(smi, kind)
    for line in lines:
        if line["name"] in hot_calls:
            # calls on phase 27's eager run of the hot/cold placement
            line["launches_hotcold"] = hot_calls[line["name"]]
        if line["name"] in guarded_calls:
            # calls on phase 31's eager guarded hot/cold steps
            line["launches_hotcold_guarded"] = guarded_calls[line["name"]]
        if line["name"] in sharded_calls:
            # calls on phases 33 and 34's eager runs
            line["launches_sharded"] = sharded_calls[line["name"]]
            line["launches_sharded_sparse"] = hybrid_calls[line["name"]]
            # calls on phase 35's eager guarded steps (a NaN batch 2nd)
            line["launches_sharded_guarded"] = \
                sharded_guarded["sharded"][line["name"]]
            line["launches_sharded_sparse_guarded"] = \
                sharded_guarded["sharded_sparse"][line["name"]]
    lines.append(lm_phases(smi, kind))
    phase_end()
    attn_lm_phases(smi, kind)
    phase_end()
    hybrid_lm_phases(smi, kind)
    phase_end()
    for name, extra in lm_train_phases(smi, kind).items():
        # this slice's path, LM training: its shapes' numbers, and the
        # calls on phase 48's 10-step run
        next(line for line in lines if line["name"] == name).update(extra)
    phase_end()
    print(f"[exit] threads alive: "
          f"{[(t.name, t.daemon) for t in threading.enumerate()]}",
          flush=True)
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
