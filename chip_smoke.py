"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card: name and power limit (nvidia-smi); TF32 off for matmul and cuDNN
  2. build: compile the three CowClip kernels (the fused CowClip +
     coupled-L2 + Adam update and the sparse pair) for sm_90a into one
     extension from src/repro_torch/kernels/cowclip/csrc
  3. fused kernel vs its plain PyTorch version at [10131227, 10],
     [10131227, 1] and [4, 10], steps 1 and 1000, rtol 1e-5 / atol 1e-7
  4. train: DeepFM at deepfm-criteo width (26 fields, 33.76M ids, emb 10,
     MLP 3x400, 13 dense) on synthetic Zipf data, batch 131072 (base 1024),
     4 steps of the fused placement plus one eval through train_ctr; the
     kernel must launch exactly 52 times per step and the loss stay finite
  5. trace: 2 more fused steps under torch.profiler, device time by kernel
  6. agreement: 3 fused steps at a small size on the card against the same
     steps on the CPU (the path the CPU tests hold to the JAX package)
  7. fused kernel time on the largest table with CUDA events, beside its
     bound and the plain version's time
  8. sparse kernels vs their plain versions: [10131227, 10] and
     [10131227, 1] at capacity 131072 (one Zipf batch of the largest field's
     unique ids plus pads), pending depths 0-1000, steps 1 and 1000; a
     [4, 10] case; a row_offset case against the last of 4 row shards of
     the largest table; rtol 1e-5 / atol 1e-7
  9. sparse train: the same model, data and hypers through the sparse
     placement, 4 steps, flush and one eval through train_ctr; each sparse
     kernel must launch exactly 52 times per step and the fused one never
 10. sparse trace: 2 more sparse steps under torch.profiler
 11. sparse agreement at phase 6's small size: 3 sparse steps on the card
     against the CPU path, the same steps twice on the card bitwise equal,
     and flushed sparse against fused on the card
 12. sparse kernel times at [10131227, 10] and [10131227, 1] with CUDA
     events (L2 flushed before each launch), beside their byte bounds and
     the plain versions' times
The last two lines are the kernels' JSON summary and the result line.
Exits non-zero, printing no result, without a CUDA device or without the
repository's src/ beside this file.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
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
PORT_KERNELS = ("cowclip_adam_kernel", "sparse_catchup_kernel",
                "sparse_update_kernel")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_time_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_time_cold_ms(fn, iters, scratch, warmup=1):
    """Mean time of ``fn`` with the L2 cache flushed before each launch
    (the main path meets its table rows cold): CUDA events around each
    call alone. The flush reads ``scratch``, so it leaves no dirty lines
    whose write-back would be timed with ``fn``."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        scratch.max()
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
    result and fold the max abs error into ``worst[0]``."""
    err = (a - b).abs()
    # share of the allowed error used by the worst element (<= 1 passes);
    # a plain relative error is meaningless where the reference is near 0
    used = (err / (ATOL + RTOL * b.abs())).max().item()
    ok = torch.allclose(a, b, rtol=RTOL, atol=ATOL)
    worst[0] = max(worst[0], err.max().item())
    print(f"[{phase}] {tag}: max_abs {err.max().item():.3e}, worst "
          f"|err|/(atol + rtol*|ref|) {used:.3f} (rtol {RTOL}, atol {ATOL}) "
          f"{'ok' if ok else 'FAIL'}")
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


def catchup_bound(counts, dim):
    """Least time for one catch-up: every slot reads its uid and count and
    writes 3 rows; a real slot also reads its last_step and 3 table rows.
    About 2 f32 operations per real element plus one pow per real slot."""
    cap = counts.numel()
    real = int((counts > 0).sum())
    nbytes = cap * (8 + 12 * dim) + real * (4 + 12 * dim)
    flops = real * (dim + 20)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), real, nbytes


def scatter_bound(counts, dim):
    """Least time for one update: every slot reads its count; a real slot
    reads its uid and 4 slot rows (w, g, m, v) and writes 3 table rows and
    its last_step. About 25 f32 operations per real element."""
    cap = counts.numel()
    real = int((counts > 0).sum())
    nbytes = cap * 4 + real * (8 + 28 * dim)
    flops = real * dim * 25
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), real, nbytes


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
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), touched, nbytes


def trace_steps(bundle, params, state, tr, tag):
    """2 steps under torch.profiler: device busy time against wall time,
    and device time by kernel."""
    from repro_torch.data import iterate_batches

    batches = iterate_batches(tr, BATCH, seed=1)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            batch = {k: torch.as_tensor(x, device="cuda")
                     for k, x in next(batches).items()}
            params, state, aux = bundle.step(params, state, batch)
            float(aux["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    if busy_ms:
        print(f"[trace] {tag}, 2 steps: device busy {busy_ms:.1f} ms of "
              f"{wall_ms:.1f} ms wall ({100 * (1 - busy_ms / wall_ms):.1f}% "
              f"idle); by kernel:")
        # the top 12, and the port's own kernels wherever they rank
        for rank, (ms_k, n, name) in enumerate(kernels):
            if rank < 12 or any(k in name for k in PORT_KERNELS):
                print(f"[trace] #{rank + 1:<3d} {ms_k:9.3f} ms x{n:<4d} "
                      f"{name[:100]}")
    else:
        print(f"[trace] {tag}: the profiler saw no device time: not measured")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    sys.path.insert(0, str(src))
    from repro_torch.configs.deepfm_criteo import CONFIG, CRITEO_VOCABS
    from repro_torch.core.scaling import scale_hyperparams
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import make_ctr_dataset
    from repro_torch.embed import store_for
    from repro_torch.kernels.cowclip import cowclip as cowclip_build
    from repro_torch.kernels.cowclip import (fused_cowclip_adam, reference,
                                             sparse_gather_catchup,
                                             sparse_update_scatter)
    from repro_torch.kernels.cowclip import ref as cc_ref
    from repro_torch.models import ctr
    from repro_torch.train import train_ctr

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

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    cowclip_build.build()
    print(f"[build] cowclip_adam.cu + sparse_catchup.cu + sparse_update.cu "
          f"+ binding.cpp for sm_90a in {time.perf_counter() - t0:.1f} s",
          flush=True)

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
    torch.cuda.empty_cache()

    # -- 4. train through the fused placement ---------------------------
    cfg = dataclasses.replace(CONFIG, placement="fused", emb_sigma=1e-2)
    check(cfg.vocab_sizes == CRITEO_VOCABS and cfg.n_dense == 13
          and cfg.emb_dim == 10 and cfg.mlp_dims == (400, 400, 400),
          "not the deepfm-criteo width")
    n_samples = math.ceil(TRAIN_STEPS * BATCH / 0.9 / BATCH) * BATCH
    t0 = time.perf_counter()
    ds = make_ctr_dataset(n_samples, CRITEO_VOCABS, n_dense=13, zipf_a=1.1,
                          seed=0)
    tr, te = ds.split(0.9)
    print(f"[train] synthetic Zipf data: {len(tr)} train / {len(te)} test "
          f"rows in {time.perf_counter() - t0:.1f} s", flush=True)
    hp = scale_hyperparams("cowclip", base_lr=1e-4, base_l2=1e-5,
                           base_batch=BASE_BATCH, batch_size=BATCH,
                           base_dense_lr=2e-4)
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
    print(f"[train] ms/step after the first: "
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
    trace_steps(bundle, res.params, res.opt_state, tr, "fused")
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
    timings = {}
    for label, cnt in (("one batch's counts", step_cnt), ("half touched", None)):
        w, g, cnt, m, v = kernel_inputs(gen, rows, dim, cnt=cnt)
        ms = cuda_time_ms(lambda: fused_cowclip_adam(w, g, cnt, m, v, 5,
                                                     **step_kw), 20)
        plain_ms = cuda_time_ms(lambda: reference(w, g, cnt, m, v, 5,
                                                  **step_kw), 5)
        bound_ms, bound_by, touched, nbytes = update_bound(cnt, dim)
        timings[label] = (ms, plain_ms, bound_ms, bound_by)
        print(f"[time] [{rows}, {dim}] {label} ({touched} rows touched): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s), {kind} at "
              f"{smi.strip().split(', ')[-1]}", flush=True)
        del w, g, cnt, m, v
    ms, plain_ms, bound_ms, bound_by = timings["one batch's counts"]
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
    fused_cowclip_adam.launches = 0
    sparse_gather_catchup.launches = 0
    sparse_update_scatter.launches = 0
    sres = train_ctr(cfg_s, None, tr, te, batch_size=BATCH, epochs=1,
                     seed=0, step_bundle=sbundle._replace(step=recorded_step),
                     max_steps=TRAIN_STEPS, device="cuda")
    torch.cuda.synchronize()
    s_launches = (sparse_gather_catchup.launches,
                  sparse_update_scatter.launches)
    f_launches = fused_cowclip_adam.launches
    print(f"[sparse-train] deepfm-criteo sparse: batch {BATCH}, {sres.steps} "
          f"steps, launches: sparse_gather_catchup {s_launches[0]}, "
          f"sparse_update_scatter {s_launches[1]} (expected {n_tables} x "
          f"{TRAIN_STEPS} each), cowclip_adam {f_launches} (expected 0)")
    for i, (loss, sec, depth) in enumerate(zip(sres.losses,
                                               sres.step_seconds, depths)):
        print(f"[sparse-train] step {i + 1}: loss {loss:.6f} "
              f"{sec * 1e3:.1f} ms, catchup_depth_max {int(depth)}")
    steady = sres.step_seconds[1:]
    print(f"[sparse-train] ms/step after the first: "
          f"{1e3 * sum(steady) / len(steady):.1f}; eval AUC "
          f"{sres.final_eval['auc']:.6f} logloss "
          f"{sres.final_eval['logloss']:.6f} "
          f"({sres.final_eval['eval_rows_per_sec']:.0f} rows/s); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    check(sres.steps == TRAIN_STEPS, f"sparse ran {sres.steps} steps")
    check(s_launches == (n_tables * TRAIN_STEPS,) * 2,
          f"sparse kernels launched {s_launches} times, expected "
          f"{n_tables * TRAIN_STEPS} each")
    check(f_launches == 0, f"the fused kernel launched {f_launches} times "
                           f"on the sparse path")
    check(all(math.isfinite(x) for x in sres.losses), "non-finite sparse loss")
    auc = sres.final_eval["auc"]
    check(math.isfinite(auc) and 0.0 <= auc <= 1.0, f"sparse AUC {auc}")
    for leaf in tree_leaves(sres.params):
        check(bool(torch.isfinite(leaf).all()), "non-finite sparse params")

    # -- 10. where a sparse step's device time goes ----------------------
    trace_steps(sbundle, sres.params, sres.opt_state, tr, "sparse")
    del sres, sbundle, ds, tr, te
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
                catchup_bound(counts_big, dim)),
            "sparse_update_scatter": (
                lambda: sparse_update_scatter(w, m, v, ls, *upd, r=1.0,
                                              zeta=1e-5, **sparse_kw),
                lambda: cc_ref.sparse_update_scatter_reference(
                    w, m, v, ls, *upd, r=1.0, zeta=1e-5, **sparse_kw),
                scatter_bound(counts_big, dim)),
        }
        for name, (kernel_fn, plain_fn, bound) in runs.items():
            k_ms = cuda_time_cold_ms(kernel_fn, 20, scratch)
            p_ms = cuda_time_cold_ms(plain_fn, 5, scratch)
            b_ms, b_by, real, nbytes = bound
            sparse_times[name, dim] = (k_ms, p_ms, b_ms, b_by)
            print(f"[time] {name} [{vocab}, {dim}] cap {cap} ({real} real "
                  f"slots, L2 flushed): kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({nbytes} B "
                  f"at {HBM_BYTES_PER_S / 1e12} TB/s), {kind} at "
                  f"{smi.strip().split(', ')[-1]}", flush=True)
        del w, m, v, ls, g, rows_c, upd, runs
    del scratch

    lines = [fused_line]
    for name, source, replaces, n, err in (
            ("sparse_gather_catchup", "sparse_catchup.cu", 93, s_launches[0],
             err_c[0]),
            ("sparse_update_scatter", "sparse_update.cu", 179, s_launches[1],
             err_u[0])):
        k_ms, p_ms, b_ms, b_by = sparse_times[name, CONFIG.emb_dim]
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
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
