"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card: name and power limit (nvidia-smi); TF32 off for matmul and cuDNN
  2. build: the four kernels (the fused CowClip + coupled-L2 + Adam
     update, the sparse pair and the chunked WKV6 scan) for sm_90a into
     one extension, from the sources under src/repro_torch/kernels
  3. fused kernel vs its plain PyTorch version at [10131227, 10],
     [10131227, 1] and [4, 10], and at the redesign's edges: V = 100003
     (no multiple of the rows a warp's tile covers) with D in {1, 2, 3,
     10, 16, 17, 64}, all rows absent and all touched; steps 1 and 1000,
     rtol 1e-5 / atol 1e-7
  4. train: DeepFM at deepfm-criteo width (26 fields, 33.76M ids, emb 10,
     MLP 3x400, 13 dense) on synthetic Zipf data, batch 131072 (base 1024),
     4 steps of the fused placement plus one eval through train_ctr; the
     kernel must launch exactly 52 times per step and the loss stay
     finite; ms/step from train_ctr's CUDA events
  5. trace: 2 more fused steps through train_ctr under torch.profiler,
     device time by kernel, the fused update's kernels a step, and every
     host read of a scalar (aten::_local_scalar_dense) per step, whether
     it copies from the card, with the ops and port source that made it:
     none may copy from the card (PyTorch's embedding backward alone
     excepted, and listed); a known device read is first seen as one
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
     single-table wrappers and the fused kernel never
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
The last two lines are the kernels' JSON summary and the result line.
Exits non-zero, printing no result, without a CUDA device or without the
repository's src/ beside this file.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
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
PORT_KERNELS = FUSED_KERNELS + SPARSE_KERNELS + WKV6_KERNELS
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
LM_AGREE = 1e-4                # max abs logits, card vs CPU (f32, reduced)


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


def criteo_data():
    """The CTR phases' synthetic Zipf data at deepfm-criteo width, enough
    for TRAIN_STEPS batches: (train, test)."""
    from repro_torch.configs.deepfm_criteo import CRITEO_VOCABS
    from repro_torch.data import make_ctr_dataset

    n_samples = math.ceil(TRAIN_STEPS * BATCH / 0.9 / BATCH) * BATCH
    return make_ctr_dataset(n_samples, CRITEO_VOCABS, n_dense=13, zipf_a=1.1,
                            seed=0).split(0.9)


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


def time_sparse_step(cc, gen, vocabs, slot_sets, dims, scratch, *, lr, l2,
                     step=1000, plain=True, iters=20):
    """One step's catch-up and update over every table (``step_tables``
    of ``slot_sets``), each timed with the L2 flushed before it and the
    host's work covered (STEP_COVER_CYCLES), and with the flush alone;
    ``cc`` is the wrappers' module (``repro_torch.kernels.cowclip``): its
    grouped wrappers where it has them, else its single-table ones, one
    call a table. With ``plain``, the plain versions' time too, table by
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
    the device-side spans of the steps' labels), sorted by device time."""
    return sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and e.self_device_time_total > 0
         and not e.key.startswith(STEP_LABEL)), reverse=True)


def device_time_by_kernel(fn):
    """Run ``fn`` once under torch.profiler: (wall ms, [(device ms, count,
    name)] sorted by device time)."""
    wall_ms, prof = profiled(fn)
    return wall_ms, by_kernel(prof)


def print_trace(prefix, tag, wall_ms, by_kernel, group=None, steps=None):
    """Device busy time against wall time, then device time by kernel with
    its share: the top 12, and the port's own kernels wherever they rank.
    ``group`` = (label, names): those kernels' device time summed, with
    its share (and per step, over ``steps`` steps)."""
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
    if group:
        label, names = group
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
# ops under which PyTorch itself may read a device scalar (a segment
# count of the CUDA embedding backward); such a read is listed, not fatal
TOLERATED_READ_OPS = ("aten::embedding_dense_backward",)


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
    card (a loss read in the loop, ``bincount``'s max and min), unless it
    is under one of TOLERATED_READ_OPS; and first fails unless a known
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
    print_trace("trace", f"{tag}, 2 steps", wall_ms, by_kernel(prof),
                group=group, steps=2)
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
    tolerated = [r[:4] for r in reads if r[1] == "device"
                 and any(op in r[4] for op in TOLERATED_READ_OPS)]
    for read in sorted(set(tolerated)):
        print(f"[trace] {tag}: x{tolerated.count(read)} PyTorch's own read "
              f"of a device scalar, left to ROADMAP queue 1 item 3: {read}")
    bad = [r[:4] for r in reads if r[1] == "device"
           and not any(op in r[4] for op in TOLERATED_READ_OPS)]
    check(not bad, f"{tag}: host reads of a device scalar: {bad}")


def run_small(cfg, hp, path, dev, params0, ds, steps=3):
    """``steps`` steps of ``path`` on ``dev`` from ``params0`` over the
    first batches of ``ds``, then ``flush``; the params' leaves on the
    CPU."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.embed import store_for

    b = store_for(cfg, path=path).make_bundle(cfg, hp, warmup_steps=2)
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
                                             sparse_update_scatter_tables)
    from repro_torch.kernels.cowclip import ref as cc_ref
    from repro_torch.models import ctr
    from repro_torch.train import train_ctr

    # -- 3. kernel vs plain version -------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(r=1.0, zeta=1e-5, lr=1e-4, l2=1e-5)
    max_abs_err = [0.0]
    for rows, dim in ((10131227, 10), (10131227, 1), (4, 10)):
        for step in (1, 1000):
            w, g, cnt, m, v = kernel_inputs(gen, rows, dim)
            ref = reference(w, g, cnt, m, v, step, **kw)
            out = fused_cowclip_adam(w, g, cnt, m, v, step, **kw)
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
                ref = reference(w, g, cnt, m, v, step, **kw)
                out = fused_cowclip_adam(w, g, cnt, m, v, step, **kw)
                torch.cuda.synchronize()
                for name, a, b in zip("wmv", out, ref):
                    compare("kernel", f"edge [{edge_rows}, {dim}] all {which} "
                            f"step {step} {name}", a, b, max_abs_err)
                del w, g, cnt, m, v, ref, out
    torch.cuda.empty_cache()

    # -- 4. train through the fused placement ---------------------------
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
    fused_cowclip_adam.launches = 0
    res = train_ctr(cfg, None, tr, te, batch_size=BATCH, epochs=1, seed=0,
                    step_bundle=bundle, max_steps=TRAIN_STEPS, device="cuda")
    torch.cuda.synchronize()
    launches = fused_cowclip_adam.launches
    n_ids = sum(CRITEO_VOCABS)
    print(f"[train] deepfm-criteo fused: {n_ids} ids x (10 + 1), batch "
          f"{BATCH}, {res.steps} steps, kernel launches {launches} "
          f"(expected {n_tables} x {TRAIN_STEPS})")
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
    # after the launch count was read, so these launches are not counted
    trace_steps(cfg, bundle, res.params, res.opt_state, tr, "fused",
                ("the fused update's kernels", FUSED_KERNELS))
    del res, bundle
    torch.cuda.empty_cache()

    # -- 6. agreement with the CPU path on a small input -----------------
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
    rows, dim = CRITEO_VOCABS[big_field], CONFIG.emb_dim
    step_kw = dict(r=1.0, zeta=1e-5, lr=hp.emb_lr, l2=hp.emb_l2)
    # L2 flushed before each launch, the host's work covered: at D = 1 a
    # launch is shorter than the wrapper's host work, which back-to-back
    # launches would time
    timings = {}
    scratch = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for label, dim, cnt in (("one batch's counts", dim, step_cnt),
                            ("half touched", dim, None),
                            ("one batch's counts", 1, step_cnt)):
        w, g, cnt, m, v = kernel_inputs(gen, rows, dim, cnt=cnt)

        def run():
            fused_cowclip_adam(w, g, cnt, m, v, 5, **step_kw)

        ms = cuda_time_cold_ms(run, 20, scratch)
        flush_ms = cuda_time_cold_ms(run, 20, scratch, cover=False)
        plain_ms = cuda_time_cold_ms(lambda: reference(
            w, g, cnt, m, v, 5, **step_kw), 5, scratch)
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
            got = sparse_gather_catchup(w, m, v, ls, uids, counts, step, **kw)
            want = cc_ref.sparse_gather_catchup_reference(
                w, m, v, ls, uids, step, **kw)
            torch.cuda.synchronize()
            for name, a, b in zip("wmv", got, want):
                check(bool(torch.isfinite(a).all()),
                      f"non-finite catch-up rows at {label}")
                compare("sparse-kernel", f"catch-up {label} step {step} "
                        f"{name}_rows (real slots)", a[real], b[real], err_c)
            g = 0.1 * torch.randn(counts.numel(), dim, generator=gen,
                                  device="cuda")
            tables = [t.clone() for t in (w, m, v, ls)]
            upd = (uids, counts, got[0], g, got[1], got[2], step)
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
        rows, depth = sparse_gather_catchup_tables(*cols, step, **sparse_kw)
        grads = [0.1 * torch.randn(r[0].shape, generator=gen, device="cuda")
                 for r in rows]
        tables = [[t.clone() for t in c] for c in cols[:4]]
        sparse_update_scatter_tables(
            *tables, cols[4], cols[5], [r[0] for r in rows], grads,
            [r[1] for r in rows], [r[2] for r in rows], step, r=1.0,
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
                w, m, v, ls, uids, step, **sparse_kw)
            for name, a, b in zip("wmv", rows[i], want):
                check(bool(torch.isfinite(a).all()),
                      f"non-finite catch-up rows, {tag}")
                compare(None, f"catch-up {tag} {name}_rows (real slots)",
                        a[real], b[real], worst_rows)
            want = cc_ref.sparse_update_scatter_reference(
                w, m, v, ls, uids, counts, rows[i][0], grads[i], rows[i][1],
                rows[i][2], step, r=1.0, zeta=1e-5, **sparse_kw)
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
        del group, cols, rows, depth, grads, tables, stacked
        torch.cuda.empty_cache()

    # -- 9. train through the sparse placement ---------------------------
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
    for wrapper in counters:
        wrapper.launches = 0
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
    check(all(math.isfinite(x) for x in sres.losses), "non-finite sparse loss")
    auc = sres.final_eval["auc"]
    check(math.isfinite(auc) and 0.0 <= auc <= 1.0, f"sparse AUC {auc}")
    for leaf in tree_leaves(sres.params):
        check(bool(torch.isfinite(leaf).all()), "non-finite sparse params")

    # -- 10. where a sparse step's device time goes ----------------------
    trace_steps(cfg_s, sbundle, sres.params, sres.opt_state, tr, "sparse",
                ("the sparse pair's kernels", SPARSE_KERNELS))
    del sres, sbundle, tr, te
    torch.cuda.empty_cache()

    # -- 11. sparse agreement on a small input ---------------------------
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
    scratch = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    sparse_times = {}
    for dim in (CONFIG.emb_dim, 1):
        w, m, v, ls = sparse_tables(gen, vocab, dim, 1000)
        g = 0.1 * torch.randn(cap, dim, generator=gen, device="cuda")
        rows_c = sparse_gather_catchup(w, m, v, ls, uids_big, counts_big,
                                       1000, **sparse_kw)
        upd = (uids_big, counts_big, rows_c[0], g, rows_c[1], rows_c[2],
               1000)
        runs = {
            "sparse_gather_catchup": (
                lambda: sparse_gather_catchup(w, m, v, ls, uids_big,
                                              counts_big, 1000, **sparse_kw),
                lambda: cc_ref.sparse_gather_catchup_reference(
                    w, m, v, ls, uids_big, 1000, **sparse_kw),
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
    from repro_torch.kernels import cowclip as cc

    power = smi.strip().split(", ")[-1]
    per_table = types.SimpleNamespace(
        sparse_gather_catchup=sparse_gather_catchup,
        sparse_update_scatter=sparse_update_scatter)
    for form, module, plain in (("one grouped launch", cc, True),
                                (f"{n_tables} single-table launches",
                                 per_table, False)):
        times = time_sparse_step(module, gen, CRITEO_VOCABS, slot_sets, dims,
                                 scratch, plain=plain, **sparse_kw)
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
    from repro_torch.serve.decode import greedy_generate

    power = smi.strip().split(", ")[-1]
    gen = torch.Generator(device="cuda").manual_seed(14)
    err = [0.0]

    # -- 13. wkv6 kernel vs its plain versions ---------------------------
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

    # -- 14. rwkv6-7b at full width: score-only prefill (the main path) --
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
    gen_prompt = torch.as_tensor(make_lm_tokens(
        GEN_BATCH * GEN_PROMPT, cfg.vocab_size, seed=2).reshape(
            GEN_BATCH, GEN_PROMPT), device="cuda")
    timing, gen_launches = {}, []
    for new in (0, GEN_NEW):
        wkv6.launches = 0
        t0 = time.perf_counter()
        res = greedy_generate(params, cfg, gen_prompt, new)
        torch.cuda.synchronize()
        timing[new] = time.perf_counter() - t0
        gen_launches.append(wkv6.launches)
    check(gen_launches == [cfg.n_layers] * 2,
          f"greedy generation launched wkv6 {gen_launches} times, expected "
          f"{cfg.n_layers} per cached prefill and none in decode")
    check(tuple(res.tokens.shape) == (GEN_BATCH, GEN_NEW)
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all())
          and bool(torch.isfinite(res.logits).all()),
          "greedy generation: bad tokens or non-finite logits")
    decode_ms = (timing[GEN_NEW] - timing[0]) * 1e3 / GEN_NEW
    print(f"[gen] {GEN_BATCH} requests x {GEN_PROMPT}-token prompts, "
          f"{GEN_NEW} greedy tokens: cached prefill {timing[0] * 1e3:.1f} ms, "
          f"{decode_ms:.2f} ms per decoded token ({GEN_BATCH * 1e3 / decode_ms:.0f} "
          f"tokens/s), {kind} at {power}; wkv6 launches {gen_launches}; "
          f"first tokens {res.tokens[0, :8].tolist()}", flush=True)
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

    # -- 16. where a full-width prefill's and a decode step's time goes --
    print_trace("lm-trace", f"prefill {list(LM_PREFILL)}",
                *device_time_by_kernel(lambda: prefill(LM_PREFILL)),
                group=("the wkv6 scan's kernels", WKV6_KERNELS))
    with torch.inference_mode():
        first, cache, cur = lm.prefill_with_cache(params, cfg, gen_prompt,
                                                  GEN_PROMPT + 1)

    def decode_one():
        with torch.inference_mode():
            lm.decode_step(params, cfg, first.argmax(-1), cache, cur)

    print_trace("lm-trace", f"decode step, batch {GEN_BATCH}",
                *device_time_by_kernel(decode_one))
    del first, cache
    del params, prompts, gen_prompt
    gc.collect()
    torch.cuda.empty_cache()

    # -- 17. agreement with the CPU path at the reduced f32 size ---------
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

    # -- 18. kernel times: L2 flushed before each launch -----------------
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    sys.path.insert(0, str(src))
    from repro_torch.kernels.extension import build

    # -- 1. card ---------------------------------------------------------
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

    # -- 2. build: the four kernels, one extension -----------------------
    t0 = time.perf_counter()
    build()
    print(f"[build] cowclip_adam.cu + sparse_catchup.cu + sparse_update.cu "
          f"+ wkv6.cu + binding.cpp for sm_90a, one extension, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    lines = ctr_phases(smi, kind)
    gc.collect()
    torch.cuda.empty_cache()
    lines.append(lm_phases(smi, kind))
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
