"""Time the port's kernels and its graph train steps on one card.

    python scripts/time_torch_kernels.py [--src DIR]
                                         [--kernels update,sparse,wkv6,wkv6_backward,ssd,embed,steps]
                                         [--quick]

Times with ``chip_smoke.py``'s own timer, inputs and bounds (imported from
it): CUDA events, the L2 flushed before each launch and the host's work
covered. It prints each kernel's registers, shared memory and stack
(``cuobjdump``), then:

* ``update``: the fused CowClip + Adam update at [10131227, 10] and
  [10131227, 1] (the largest deepfm-criteo table) with one batch's share
  of rows touched, and at [10131227, 10] with half of them touched; each
  timed with the host's work covered and with the L2 flush alone, beside
  its bound;
* ``sparse``: the sparse pair (``sparse_gather_catchup``,
  ``sparse_update_scatter``) over one step's 52 deepfm-criteo tables (the
  26 fm tables at D = 10 and the 26 LR ones at D = 1, slot sets of
  ``chip_smoke.py`` phase 9's first batch of 131072, pending depths
  0-1000, step 1000), each kernel timed over the whole step with the host's
  work covered and with the L2 flush alone, beside its per-step bound:
  through the grouped wrappers where the timed port has them, else
  through the single-table wrappers a table at a time (the form before
  the grouped launch); then the largest table alone at D = 10 and D = 1
  through the single-table wrappers, three timings each;
* ``wkv6``: ``chunked_wkv6`` at [256, 4096, 64] and [64, 32768, 64] (the
  main path's prefill shapes) for several segment lengths, the card's own
  choice first;
* ``wkv6_backward``: at rwkv6-7b's training call [512, 512, 64] and at
  [1, 4000, 64] (BH far below the SMs), the forward with and without its
  kept chunk states and the backward kernel beside its bound (the
  timed port must have the backward; an earlier one is skipped);
* ``ssd``: the Mamba-2 scan's forward at zamba2-2.7b's layer
  (``chip_smoke.SSD_LAYER``, 1 x 4096 x 80 x 64 x 64), without and with
  its kept chunk states, beside its bound, through the op both ports have
  (``repro_torch::ssd_scan_fwd``), then, where the timed port cuts the
  sequence into segments, for several segment lengths, the card's own
  choice first; and its backward at ``chip_smoke.SSD_TRAIN[-1]`` (2 x 512
  x 80 x 64 x 64) from the forward's kept states, beside its bound, the
  written-out plain backward and, where the timed port has it, the chunk
  form's plain backward;
* ``embed``: a step's embedding backward over one batch's 26
  deepfm-criteo fields (``chip_smoke.py`` phase 4's first batch of
  131072; the fm lookup at D = 10 and the LR one at D = 1), in the timed
  port's own form: one call over both (``embedding_backward_groups`` on
  the keys' ``sort_plan``) where it has one, else a call a lookup
  (``embedding_backward``, each with its sort); then each lookup alone
  through ``embedding_backward`` and PyTorch's ``embedding_dense_backward``
  in one call over both lookups' columns, each beside its byte bound;
* ``steps``: the steady ms/step of the fused and the sparse placement at
  deepfm-criteo width and batch 131072, eager and from the scan engine's
  graph (4 steps a chunk) in turns over 25 chunks, batches on the card
  (``chip_smoke.steady_ms``), from the timed port's own bundles, under
  PyTorch's default algorithms.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that another commit's kernels, unpacked
with ``git archive``, are timed with this timer: run one process per
checkout; to hold a change against its parent, run them in turns in one
call: parent, change, change, parent. Where a port's CowClip wrappers read
the step from device memory, its block is made once, before the timed
launches (``step_arg``). Every line names the card and its
power limit. ``--quick`` times one segment length per shape. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

CRITEO_ROWS = 10131227         # the largest deepfm-criteo table
BATCH_TOUCHED = 36430          # its rows one batch of 131072 touches


def step_arg(cc, step):
    """``step`` as the wrappers of ``cc`` (a checkout's
    ``repro_torch.kernels.cowclip``) take it: where they read the step
    from the card, its ``StepScalars`` block, made here once, outside the
    timed launches; an earlier port's wrappers take the int."""
    make = getattr(cc, "step_scalars", None)
    return make(step, device="cuda") if make is not None else step


def resources(ext):
    """Print the registers, shared memory and stack of each kernel."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    usage = subprocess.run([str(tool), "--dump-resource-usage",
                            str(Path(ext.__file__))], capture_output=True,
                           text=True, timeout=120)
    for line in usage.stdout.splitlines():
        if "Function" in line or "REG" in line:
            print("[resources]", line.strip())


def time_update(gen, scratch, card):
    from repro_torch.kernels import cowclip as cc

    step = step_arg(cc, 5)
    for dim, label, frac in ((10, "one batch's share",
                              BATCH_TOUCHED / CRITEO_ROWS),
                             (1, "one batch's share",
                              BATCH_TOUCHED / CRITEO_ROWS),
                             (10, "half", 0.5)):
        w, g, cnt, m, v = smoke.kernel_inputs(gen, CRITEO_ROWS, dim,
                                              touched_frac=frac)

        def run():
            cc.fused_cowclip_adam(w, g, cnt, m, v, step, lr=1e-3, l2=1e-4)

        covered = smoke.cuda_time_cold_ms(run, 20, scratch)
        flush = smoke.cuda_time_cold_ms(run, 20, scratch, cover=False)
        b_ms, b_by, touched, _ = smoke.update_bound(cnt, dim)
        print(f"[time] cowclip_adam_update [{CRITEO_ROWS}, {dim}] {label} "
              f"touched ({touched} rows): {covered:.4f} ms (L2 flushed, host "
              f"covered), {flush:.4f} ms (L2 flushed only), bound "
              f"{b_ms:.4f} ms by {b_by}, {card}", flush=True)
        del w, g, cnt, m, v


def time_sparse(gen, scratch, card):
    from repro_torch.configs.deepfm_criteo import CRITEO_VOCABS
    from repro_torch.data import iterate_batches
    from repro_torch.kernels import cowclip as cc

    tr, _ = smoke.criteo_data()
    first = next(iterate_batches(tr, smoke.BATCH, seed=0))
    ids = torch.as_tensor(first["ids"], device="cuda")
    slot_sets = smoke.step_slot_sets(ids, CRITEO_VOCABS)
    hp = smoke.criteo_hypers()
    form = ("one grouped launch" if hasattr(cc, "sparse_gather_catchup_tables")
            else f"{2 * len(CRITEO_VOCABS)} single-table launches")
    times = smoke.time_sparse_step(cc, gen, CRITEO_VOCABS, slot_sets, (10, 1),
                                   scratch, step_arg(cc, 1000),
                                   lr=hp.emb_lr, l2=hp.emb_l2, plain=False)
    for name, (ms, flush, _, b_ms, b_by, real, nbytes) in times.items():
        print(f"[time] {name}, one step's {2 * len(CRITEO_VOCABS)} tables "
              f"({real} real slots), {form}: {ms:.4f} ms (L2 flushed, host "
              f"covered), {flush:.4f} ms (L2 flushed only), bound {b_ms:.4f} "
              f"ms by {b_by} ({nbytes} B), {card}", flush=True)
    # the largest table alone, through the single-table wrappers: three
    # timings of 50 launches each, to show their spread
    big = max(range(len(CRITEO_VOCABS)), key=CRITEO_VOCABS.__getitem__)
    uids, counts = slot_sets[big]
    for dim in (10, 1):
        w, m, v, ls = smoke.sparse_tables(gen, CRITEO_VOCABS[big], dim, 1000)
        g = 0.1 * torch.randn(uids.numel(), dim, generator=gen, device="cuda")
        kw = dict(lr=hp.emb_lr, l2=hp.emb_l2)
        step = step_arg(cc, 1000)
        rows = cc.sparse_gather_catchup(w, m, v, ls, uids, counts, step, **kw)
        runs = (("sparse_gather_catchup", lambda: cc.sparse_gather_catchup(
                    w, m, v, ls, uids, counts, step, **kw)),
                ("sparse_update_scatter", lambda: cc.sparse_update_scatter(
                    w, m, v, ls, uids, counts, rows[0], g, rows[1], rows[2],
                    step, r=1.0, zeta=1e-5, **kw)))
        for name, fn in runs:
            times = [smoke.cuda_time_cold_ms(fn, 50, scratch)
                     for _ in range(3)]
            print(f"[time] {name} [{CRITEO_VOCABS[big]}, {dim}] alone (cap "
                  f"{uids.numel()}, {int((counts > 0).sum())} real slots): "
                  f"{', '.join(f'{t:.4f}' for t in times)} ms (L2 flushed, "
                  f"host covered; 3 x 50 launches), {card}", flush=True)
        del w, m, v, ls, g, rows


def time_wkv6(gen, scratch, card, quick):
    from repro_torch.kernels.wkv6.wkv6 import chunked_wkv6, segment_chunks

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for bh, seq, n in (smoke.WKV_FULL, smoke.WKV_LONG):
        r, k, v, w, u = smoke.wkv_inputs(gen, bh, seq, n)
        own = segment_chunks(bh, seq // 16, sms)
        choices = [own] if quick else [own] + [
            s for s in (seq // 16, 128, 64, 32, 16) if s != own]
        for seg in choices:
            ms = smoke.cuda_time_cold_ms(
                lambda: chunked_wkv6(r, k, v, w, u, segment=seg), 10, scratch)
            print(f"[time] chunked_wkv6 [{bh}, {seq}, {n}] segment {seg} "
                  f"chunks ({-(-seq // 16 // seg)} a bh"
                  f"{', the card default' if seg == own else ''}): "
                  f"{ms:.4f} ms (L2 flushed, host covered), {card}",
                  flush=True)
        del r, k, v, w, u


def time_wkv6_backward(gen, scratch, card):
    import importlib

    launcher = importlib.import_module("repro_torch.kernels.wkv6.wkv6")
    if not hasattr(launcher, "chunked_wkv6_backward"):
        print("[time] wkv6 backward: the timed port has no backward kernel",
              flush=True)
        return
    for bh, seq, n in (smoke.LM_TRAIN_WKV, (1, 4000, 64)):
        r, k, v, w, u = smoke.wkv_inputs(gen, bh, seq, n)
        gy = torch.randn(r.shape, generator=gen, device="cuda")
        gs = torch.randn((bh, n, n), generator=gen, device="cuda")
        _, _, kept = launcher.chunked_wkv6(r, k, v, w, u, chunk_states=True)
        f_ms = smoke.cuda_time_cold_ms(
            lambda: launcher.chunked_wkv6(r, k, v, w, u), 20, scratch)
        fk_ms = smoke.cuda_time_cold_ms(lambda: launcher.chunked_wkv6(
            r, k, v, w, u, chunk_states=True), 20, scratch)
        b_ms = smoke.cuda_time_cold_ms(lambda: launcher.chunked_wkv6_backward(
            r, k, v, w, u, kept, gy, gs), 20, scratch)
        bound, by, nbytes, flops = smoke.wkv_bwd_bound(bh, seq, n)
        print(f"[time] wkv6 [{bh}, {seq}, {n}]: forward {f_ms:.4f} ms, "
              f"keeping its chunk states {fk_ms:.4f} ms; backward kernel "
              f"{b_ms:.4f} ms, bound {bound:.4f} ms by {by} ({nbytes} B, "
              f"{flops} FLOP: {100 * bound / b_ms:.1f}% of it) (L2 "
              f"flushed, host covered), {card}", flush=True)
        del r, k, v, w, u, gy, gs, kept


def time_ssd(gen, scratch, card, quick):
    import importlib

    ssd = importlib.import_module("repro_torch.kernels.ssd")  # the ops
    launcher = importlib.import_module("repro_torch.kernels.ssd.ssd")
    fwd = torch.ops.repro_torch.ssd_scan_fwd
    bwd = torch.ops.repro_torch.ssd_scan_bwd
    b, s, h, p, n = smoke.SSD_LAYER
    ins = smoke.ssd_inputs(gen, b, s, h, p, n)
    bound, by, nbytes, flops, loop_bound = smoke.ssd_bound(b, s, h, p, n)
    with torch.no_grad():
        f_ms = smoke.cuda_time_cold_ms(lambda: fwd(*ins, False), 20, scratch)
        fk_ms = smoke.cuda_time_cold_ms(lambda: fwd(*ins, True), 20, scratch)
        print(f"[time] ssd_scan forward {list(smoke.SSD_LAYER)}: {f_ms:.4f} "
              f"ms, keeping its chunk states {fk_ms:.4f} ms; bound "
              f"{bound:.4f} ms by {by} ({nbytes} B, {flops} FLOP in the "
              f"chunk form: {100 * bound / f_ms:.1f}% of it; the token "
              f"loop's f32 bound {loop_bound:.4f} ms) (L2 flushed, host "
              f"covered), {card}", flush=True)
        if not quick and hasattr(launcher, "segment_chunks"):
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            chunks = ssd.n_chunks(s)
            rows = getattr(launcher, "ROWS", None) or launcher.FWD_ROWS
            own = launcher.segment_chunks(b * h * -(-p // rows), chunks, sms)
            for seg in [own] + [c for c in (chunks, 128, 32, 16)
                                if c != own]:
                ms = smoke.cuda_time_cold_ms(lambda: launcher.forward(
                    *ins, False, segment=seg), 20, scratch)
                print(f"[time] ssd_scan forward {list(smoke.SSD_LAYER)} "
                      f"segment {seg} chunks ({-(-chunks // seg)} a (b, h)"
                      f"{', the card default' if seg == own else ''}): "
                      f"{ms:.4f} ms (L2 flushed, host covered), {card}",
                      flush=True)
    del ins
    shape = smoke.SSD_TRAIN[-1]
    ins = smoke.ssd_inputs(gen, *shape)
    gy = torch.randn(ins[0].shape, generator=gen, device="cuda")
    gs = torch.randn(shape[:1] + shape[2:], generator=gen, device="cuda")
    with torch.no_grad():
        _, _, kept = fwd(*ins, True)
        fk_ms = smoke.cuda_time_cold_ms(lambda: fwd(*ins, True), 20, scratch)
        b_ms = smoke.cuda_time_cold_ms(lambda: bwd(*ins, kept, gy, gs), 20,
                                       scratch)
        plains = {"written-out plain backward":
                  ssd.ssd_scan_backward_reference}
        if hasattr(ssd, "ssd_scan_backward_chunked_reference"):
            plains["chunked plain backward"] = \
                ssd.ssd_scan_backward_chunked_reference
        plain_ms = {name: smoke.cuda_time_cold_ms(
            lambda fn=fn: fn(*ins, kept, gy, gs), 2, scratch)
            for name, fn in plains.items()}
    bound, by, nbytes, flops, part_bytes = smoke.ssd_bound(*shape,
                                                           backward=True)
    print(f"[time] ssd_scan {list(shape)}: forward keeping its chunk states "
          f"{fk_ms:.4f} ms; backward {b_ms:.4f} ms, bound {bound:.4f} ms by "
          f"{by} ({nbytes} B, {flops} FLOP: {100 * bound / b_ms:.1f}% of it; "
          f"the sums across heads' partial buffers {part_bytes} B more, "
          f"written and read) (L2 flushed, host covered); "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in plain_ms.items())
          + f"; {card}", flush=True)
    del ins, gy, gs, kept


def _grouped_keys(ids, vocabs):
    """Each field's ids at its own start in one row space (starts aligned
    to 64 rows, as the port's layout): ([B * F] int32 keys, rows)."""
    starts, end = [], 0
    for v in vocabs:
        starts.append(-(-end // 64) * 64)
        end = starts[-1] + v
    off = torch.tensor(starts, dtype=torch.int64, device=ids.device)
    keys = (ids.to(torch.int64) + off).to(torch.int32).reshape(-1)
    return keys, end


def time_embed(gen, scratch, card):
    from repro_torch.configs.deepfm_criteo import CRITEO_VOCABS
    from repro_torch.data import iterate_batches
    from repro_torch.kernels import embedding

    tr, _ = smoke.criteo_data()
    ids = torch.as_tensor(next(iterate_batches(tr, smoke.BATCH, seed=0))["ids"],
                          device="cuda")
    del tr
    keys, rows = _grouped_keys(ids, CRITEO_VOCABS)
    n = keys.numel()
    c10, c1 = (1e-3 * torch.randn(n, d, generator=gen, device="cuda")
               for d in (10, 1))
    both = torch.cat([c10, c1], dim=1)
    if hasattr(embedding, "embedding_backward_groups"):
        step = ("one call over both lookups",
                lambda: embedding.embedding_backward_groups(
                    embedding.sort_plan(keys), [c10, c1], rows))
    else:
        step = ("a call a lookup",
                lambda: (embedding.embedding_backward(keys, c10, rows),
                         embedding.embedding_backward(keys, c1, rows)))
    runs = [
        (f"a step's embedding backward, the port's form: {step[0]}", step[1],
         (10, 1)),
        ("the port's embedding_backward, the fm lookup alone",
         lambda: embedding.embedding_backward(keys, c10, rows), (10,)),
        ("the port's embedding_backward, the LR lookup alone",
         lambda: embedding.embedding_backward(keys, c1, rows), (1,)),
        ("PyTorch's embedding_dense_backward, both lookups' columns in one "
         "call", lambda: torch.ops.aten.embedding_dense_backward(
             both, keys, rows, -1, False), (10, 1)),
    ]
    for name, fn, dims in runs:
        b_ms, b_by, nbytes = smoke.embed_bound(n, dims, rows)
        times = [smoke.cuda_time_cold_ms(fn, 20, scratch) for _ in range(3)]
        print(f"[time] {name}, one batch's {ids.shape[1]} fields ({n} rows "
              f"into [{rows}, D], D in {dims}): "
              f"{', '.join(f'{t:.4f}' for t in times)} ms (L2 flushed, "
              f"host covered; 3 x 20 calls), bound {b_ms:.4f} ms by "
              f"{b_by} ({nbytes} B), {card}", flush=True)
    del c10, c1, both, keys


def time_steps(card):
    import dataclasses

    from repro_torch.configs.deepfm_criteo import CONFIG
    from repro_torch.data.prefetch import chunk_epoch
    from repro_torch.embed import store_for
    from repro_torch.models import ctr
    from repro_torch.train import engine as engine_lib

    tr, _ = smoke.criteo_data(steps=smoke.GRAPH_STEPS, seed=1)
    hp = smoke.criteo_hypers()
    chunk = {k: torch.as_tensor(v, device="cuda") for k, v in
             next(chunk_epoch(tr, smoke.BATCH, smoke.SCAN_STEPS,
                              seed=4)).items()}
    for placement in ("fused", "sparse"):
        cfg = dataclasses.replace(CONFIG, placement=placement,
                                  emb_sigma=1e-2)
        bundle = store_for(cfg).make_bundle(
            cfg, hp, warmup_steps=max(1, len(tr) // smoke.BATCH))
        params = ctr.init(cfg, seed=7, device="cuda")
        state = bundle.init(params)
        runner = engine_lib.make_chunk_runner(bundle.step.scan_step)
        runner(params, state, chunk)          # the capture
        eager, graph = smoke.steady_ms(bundle, runner, params, state, chunk)
        print(f"[time] {placement} step, batch {smoke.BATCH}, steady ms/step "
              f"over {len(graph)} chunks of {smoke.SCAN_STEPS} in turns: "
              f"graph {smoke.spread(graph)}, eager {smoke.spread(eager)}, "
              f"{card}", flush=True)
        del bundle, params, state, runner
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--kernels", default="update,wkv6")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels.extension import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{card}; timing {args.src.resolve()}")
    resources(build())
    scratch = torch.zeros(smoke.L2_FLUSH_BYTES, dtype=torch.uint8,
                          device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = args.kernels.split(",")
    if "update" in kernels:
        time_update(gen, scratch, card)
    if "sparse" in kernels:
        time_sparse(gen, scratch, card)
    if "wkv6" in kernels:
        time_wkv6(gen, scratch, card, args.quick)
    if "wkv6_backward" in kernels:
        time_wkv6_backward(gen, scratch, card)
    if "ssd" in kernels:
        time_ssd(gen, scratch, card, args.quick)
    if "embed" in kernels:
        time_embed(gen, scratch, card)
    if "steps" in kernels:
        time_steps(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
