"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card: name and power limit (nvidia-smi); TF32 off for matmul and cuDNN
  2. build: compile the CowClip + coupled-L2 + Adam kernel for sm_90a from
     src/repro_torch/kernels/cowclip/csrc
  3. kernel vs its plain PyTorch version at [10131227, 10], [10131227, 1]
     and [4, 10], steps 1 and 1000, rtol 1e-5 / atol 1e-7
  4. train: DeepFM at deepfm-criteo width (26 fields, 33.76M ids, emb 10,
     MLP 3x400, 13 dense) on synthetic Zipf data, batch 131072 (base 1024),
     4 steps of the fused placement plus one eval through train_ctr; the
     kernel must launch exactly 52 times per step and the loss stay finite
  5. trace: 2 more steps under torch.profiler, device time by kernel
  6. agreement: 3 fused steps at a small size on the card against the same
     steps on the CPU (the path the CPU tests hold to the JAX package)
  7. kernel time on the largest table with CUDA events, beside its bound and
     the plain version's time
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    sys.path.insert(0, str(src))
    from repro_torch.configs.deepfm_criteo import CONFIG, CRITEO_VOCABS
    from repro_torch.core.scaling import scale_hyperparams
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data import iterate_batches, make_ctr_dataset
    from repro_torch.embed import store_for
    from repro_torch.kernels.cowclip import cowclip as cowclip_build
    from repro_torch.kernels.cowclip import fused_cowclip_adam, reference
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
    print(f"[build] cowclip_adam.cu + binding.cpp for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # -- 3. kernel vs plain version -------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(r=1.0, zeta=1e-5, lr=1e-4, l2=1e-5)
    max_abs_err = 0.0
    for rows, dim in ((10131227, 10), (10131227, 1), (4, 10)):
        for step in (1, 1000):
            w, g, cnt, m, v = kernel_inputs(gen, rows, dim)
            ref = reference(w, g, cnt, m, v, step, **kw)
            out = fused_cowclip_adam(w, g, cnt, m, v, step, **kw)
            torch.cuda.synchronize()
            for name, a, b in zip("wmv", out, ref):
                err = (a - b).abs()
                # share of the allowed error used by the worst element
                # (<= 1 passes); a plain relative error is meaningless
                # where the reference is near 0
                used = (err / (ATOL + RTOL * b.abs())).max().item()
                ok = torch.allclose(a, b, rtol=RTOL, atol=ATOL)
                max_abs_err = max(max_abs_err, err.max().item())
                print(f"[kernel] [{rows}, {dim}] step {step} {name}: max_abs "
                      f"{err.max().item():.3e}, worst |err|/(atol + rtol*|ref|)"
                      f" {used:.3f} (rtol {RTOL}, atol {ATOL}) "
                      f"{'ok' if ok else 'FAIL'}")
                check(ok, f"kernel disagrees with its plain version at "
                          f"[{rows}, {dim}] step {step} ({name})")
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
    params, state = res.params, res.opt_state
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
        print(f"[trace] 2 steps: device busy {busy_ms:.1f} ms of "
              f"{wall_ms:.1f} ms wall ({100 * (1 - busy_ms / wall_ms):.1f}% "
              f"idle); by kernel:")
        for ms_k, n, name in kernels[:12]:
            print(f"[trace]   {ms_k:9.3f} ms x{n:<4d} {name[:100]}")
    else:
        print("[trace] the profiler saw no device time: not measured")
    del res, bundle, params, state, ds, tr, te
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
    runs = {}
    for dev in ("cpu", "cuda"):
        b = store_for(small).make_bundle(small, shp, warmup_steps=2)
        p = tree_map(lambda t: t.clone().to(dev), params0)
        s = b.init(p)
        for i in range(3):
            sl = slice(i * 512, (i + 1) * 512)
            batch = {"ids": torch.as_tensor(sds.ids[sl], device=dev),
                     "dense": torch.as_tensor(sds.dense[sl], device=dev),
                     "labels": torch.as_tensor(sds.labels[sl], device=dev)}
            p, s, _ = b.step(p, s, batch)
        runs[dev] = [t.cpu() for t in tree_leaves(p)]
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

    print(json.dumps({"kernels": [{
        "name": "cowclip_adam_update",
        "route": "cuda",
        "source": "src/repro_torch/kernels/cowclip/csrc/cowclip_adam.cu",
        "replaces": "src/repro/kernels/cowclip/cowclip.py:72",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
