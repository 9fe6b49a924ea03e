"""CTR training driver for the PyTorch port.

The flags are those of ``repro.launch.train`` plus ``--device`` (default
``cuda``; without a CUDA device the run stops rather than train on the
CPU). The port trains ``--placement fused`` (the default here),
``--placement sparse``, ``--placement substrate`` (the composable
optimizer chain, the reference's exactness oracle; with ``--rule`` other
than cowclip, no clip) and ``--placement hotcold`` (a hot tier of
``--hot-capacity`` rows a field beside the full tables, with the cold
tier on the card, or with ``--cold-store mem|mmap`` in host memory or
files, planned one step ahead on the stream's worker thread), with
``--engine scan`` (the default, as in the reference: ``--scan-steps``
steps captured as one CUDA graph on the card, run in turn on the CPU) or
``--engine eager``, over epochs or online (``--mode stream --steps N``,
the train split replayed as an endless event stream). Online training
takes crash-safe snapshots (``--snapshot-dir DIR --snapshot-every N``,
``train.snapshot``) and restarts from the latest valid one
(``--resume``), bitwise equal to an uninterrupted run with the same
cadence; a fault plan in ``REPRO_FAULT_PLAN`` (``testing.faults``) kills
the trainer where it says. ``--nonfinite-guard`` skips a step whose loss
is NaN/Inf on every placement but the async hot/cold one.

``--placement sharded|sharded_sparse`` trains on a ("data", "model") grid
of ranks (``--mesh DATA,MODEL``, ``--partition div|mod``; ``launch.mesh``),
one process a rank: ``--device cpu --host-devices N`` spawns N gloo CPU
ranks; on GPUs, one rank a card under ``torchrun`` (NCCL), or without it
a world of one rank on one card. Only rank 0 prints, and the eval runs on
the exported tables. The guard, ``--mode stream``, snapshots and
``--resume`` work there too: every rank draws the same event stream from
``--seed`` and keeps its data slice in the step; every rank takes part in
a snapshot's flush and gathers, and rank 0 alone writes it; every rank
resumes from the same latest valid snapshot. A rank that dies (a fault
plan's SIGKILL lands on every rank at a step boundary, and inside a
snapshot's write on rank 0 alone) ends the world: under
``--host-devices`` the parent ends the other ranks (SIGTERM, then
SIGKILL) and exits ``128 + N`` for a rank killed by signal N (137 for
SIGKILL), naming the rank on stderr (``launch.mesh.spawn_host_ranks``);
under ``torchrun`` its agent ends the others and exits non-zero.
``--task lm`` is not ported yet: it exits naming its ROADMAP item.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --task ctr \
      --placement fused --batch 8192 --epochs 2 --rule cowclip
  PYTHONPATH=src python -m repro_torch.launch.train --task ctr \
      --placement sparse --batch 8192 --epochs 2 --rule cowclip
  PYTHONPATH=src python -m repro_torch.launch.train --task ctr \
      --placement sparse --device cpu --samples 4096 --batch 512 --steps 2
  PYTHONPATH=src python -m repro_torch.launch.train --task ctr \
      --placement substrate --device cpu --samples 4096 --batch 512 --steps 2
  PYTHONPATH=src python -m repro_torch.launch.train --task ctr \
      --engine scan --scan-steps 4 --batch 8192 --epochs 1
  PYTHONPATH=src python -m repro_torch.launch.train --task ctr \
      --device cpu --mode stream --placement hotcold --hot-capacity 512 \
      --samples 4096 --batch 256 --steps 16 [--cold-store mem]
  PYTHONPATH=src python -m repro_torch.launch.train --task ctr \
      --device cpu --mode stream --placement sparse --samples 2048 \
      --batch 128 --steps 12 --snapshot-dir DIR --snapshot-every 4 [--resume]
  PYTHONPATH=src python -m repro_torch.launch.train --task ctr \
      --device cpu --placement sharded_sparse --mesh 2,2 --host-devices 4 \
      --samples 4096 --batch 512 --steps 4 [--partition mod]
  PYTHONPATH=src python -m repro_torch.launch.train --task ctr \
      --device cpu --placement sharded --mesh 2,2 --host-devices 4 \
      --mode stream --samples 2048 --batch 128 --steps 12 \
      --nonfinite-guard --snapshot-dir DIR --snapshot-every 4 [--resume]
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --task ctr \
      --placement sharded --mesh 1,4 --batch 8192 --epochs 1
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.scaling import RULES, scale_hyperparams
from ..core.tree import tree_leaves
from ..data import load_criteo_tsv, make_ctr_dataset
from ..embed.store import MESH_PLACEMENTS, store_for
from ..models import ctr as ctr_lib
from ..train import checkpoint, train_ctr
from . import mesh as mesh_lib

PLACEMENT_CHOICES = ("substrate", "fused", "sparse", "sharded",
                     "sharded_sparse", "hotcold")


def resolve_placement(placement, sparse_flag, *, warn=print) -> str:
    """Combine ``--placement`` with the deprecated ``--sparse`` alias.

    ``--sparse`` is exactly ``--placement sparse``; passing it with another
    placement is an error. With neither, the port's default, ``fused``.
    """
    if sparse_flag:
        if placement is not None and placement != "sparse":
            raise SystemExit(
                f"--sparse conflicts with --placement {placement}: --sparse "
                "is a deprecated alias for --placement sparse; drop one of "
                "the two flags")
        warn("[train] --sparse is deprecated; use --placement sparse")
        return "sparse"
    return placement or "fused"


def _check_mesh_flags(args, placement) -> None:
    """The grid flags apply to the sharded placements, and
    ``--host-devices`` spawns CPU ranks."""
    if placement not in MESH_PLACEMENTS:
        if args.mesh or args.host_devices:
            raise SystemExit("[train] --mesh and --host-devices apply to "
                             "--placement sharded|sharded_sparse")
        return
    if args.host_devices and torch.device(args.device).type != "cpu":
        raise SystemExit("[train] --host-devices spawns gloo CPU ranks; add "
                         "--device cpu (on GPUs launch one rank a card under "
                         "torchrun)")


def _check_stream_flags(args, placement) -> None:
    """The reference CLI's refusals of streaming and cold-store flag
    combinations, with its messages."""
    if args.mode == "stream" and args.steps is None:
        raise SystemExit("[train] --mode stream has no epoch boundary; pass "
                         "--steps to bound the run")
    if args.cold_store != "none":
        if placement != "hotcold":
            raise SystemExit("[train] --cold-store needs --placement hotcold "
                             "(the out-of-core tier backs the hot/cold "
                             "placement)")
        if args.mode != "stream":
            raise SystemExit("[train] --cold-store trains online only; add "
                             "--mode stream (the migration planner runs on "
                             "the stream's worker thread)")
        if args.cold_store == "mmap" and not args.cold_dir:
            raise SystemExit("[train] --cold-store mmap needs --cold-dir "
                             "(the on-disk table directory)")
    if args.snapshot_dir:
        if args.mode != "stream":
            raise SystemExit("[train] --snapshot-dir rides the stream "
                             "cursor; add --mode stream (docs/robustness.md)")
        if args.snapshot_every <= 0:
            raise SystemExit("[train] --snapshot-dir needs --snapshot-every "
                             "N (steps between snapshots)")
    elif args.resume:
        raise SystemExit("[train] --resume needs --snapshot-dir (where the "
                         "snapshots live)")


def _make_stream(args, bundle, tr, start_step=0, max_steps=None):
    """Online training's source: the train split replayed as an endless
    event stream (a stand-in for a production log tail), re-batched and
    chunk-stacked on a worker thread, from row ``start_step * batch`` (a
    resume's cursor). With the async cold store, chunks of one step
    planned on that thread (4 deep), the step budget (``max_steps``,
    default ``--steps``) enforced at the source."""
    from ..data import stream as stream_lib

    skip = start_step * args.batch
    events = stream_lib.synthetic_event_stream(
        tr, rows_per_event=max(1, args.batch // 2), seed=args.seed)
    if skip:
        events = stream_lib.skip_rows(events, skip)
    if bundle.stream_transform is not None:
        return stream_lib.stream_chunks(
            events, args.batch, 1, buffer_size=4,
            transform=bundle.stream_transform(
                max_steps=args.steps if max_steps is None else max_steps),
            start_rows=skip)
    return stream_lib.stream_chunks(
        events, args.batch,
        args.scan_steps if args.engine == "scan" else 1, start_rows=skip)


def _run_async_segments(args, cfg, bundle, tr, te, params, state,
                        start_step, snap_mgr, snap_meta, fault_plan):
    """The async hot/cold placement under snapshots: the stream runs in
    segments that end at each snapshot boundary (the transform's step
    budget), so every planned step is dispatched and the planner drained
    before the flush; the uninterrupted run takes the same boundaries, so
    resumed and uninterrupted runs stay bitwise identical. Returns a
    ``TrainResult``."""
    from ..train import snapshot as snapshot_lib
    from ..train.loop import TrainResult, make_eval_fn

    n = start_step
    t0 = time.perf_counter()
    while n < args.steps:
        target = min(n + args.snapshot_every, args.steps)
        seg = _make_stream(args, bundle, tr, n, target)
        try:
            params, state, ran, _ = bundle.stream_driver(
                params, state, seg, max_steps=None)
        finally:
            seg.close()
        n += ran
        params, state = snapshot_lib.capture(
            snap_mgr, bundle, params, state, step=n,
            cursor={"rows_consumed": n * args.batch}, meta=snap_meta)
        if fault_plan is not None:
            fault_plan.maybe_kill(n)
        if ran == 0:
            raise SystemExit("[train] stream ended before the segment "
                             f"target {target}")
    seconds = time.perf_counter() - t0
    final = (make_eval_fn(cfg)(bundle.export(params), te)
             if te is not None else {})
    return TrainResult(history=[], final_eval=dict(final), seconds=seconds,
                       steps=n, params=params, opt_state=state)


def _host_rank(rank, world, store_path, args, placement) -> None:
    """One gloo CPU rank of ``--host-devices``: its share of the host's
    cores, its process group, its part of the run."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    with mesh_lib.process_group("cpu", rank=rank, world_size=world,
                                store_path=store_path) as device:
        _run_ctr(args, placement, device)


def run_ctr(args) -> None:
    placement = resolve_placement(args.placement, args.sparse)
    _check_mesh_flags(args, placement)
    _check_stream_flags(args, placement)
    device = resolve_device(args.device)
    if placement not in MESH_PLACEMENTS:
        _run_ctr(args, placement, device)
    elif args.host_devices:
        mesh_lib.spawn_host_ranks(_host_rank, args.host_devices,
                                  (args, placement))
    else:
        with mesh_lib.process_group(device) as rank_device:
            _run_ctr(args, placement, rank_device)


def _quiet(*_args, **_kw) -> None:
    """The print of a rank other than 0."""


def _run_ctr(args, placement, device) -> None:
    """The run on one device: the whole of it for a single-device
    placement, this rank's part (inside its process group) for a sharded
    one, where rank 0 alone prints and writes the checkpoint."""
    mesh = None
    if placement in MESH_PLACEMENTS:
        mesh = mesh_lib.make_ctr_mesh(
            *(mesh_lib.parse_mesh(args.mesh) if args.mesh else (0, 0)),
            device_type=device.type)
    say = print if mesh is None or mesh.rank == 0 else _quiet

    if args.criteo:
        ds = load_criteo_tsv(args.criteo, max_rows=args.max_rows)
    else:
        vocabs = tuple(v * args.vocab_scale
                       for v in (30000, 80000, 5000, 1000, 200))
        ds = make_ctr_dataset(args.samples, vocabs, n_dense=4, zipf_a=1.1,
                              seed=args.seed)
    tr, te = ds.split(0.9)
    cfg = ctr_lib.CTRConfig(
        name=args.model, vocab_sizes=ds.vocab_sizes,
        n_dense=ds.dense.shape[1], emb_dim=args.emb_dim,
        mlp_dims=(args.mlp_dim,) * 3, emb_sigma=1e-2,
        sparse=placement == "sparse", unique_capacity=args.unique_capacity,
        placement=placement, compute_dtype=args.compute_dtype,
    )
    store = store_for(cfg, mesh=mesh, partition=args.partition,
                      hot_capacity=args.hot_capacity,
                      cold_store=args.cold_store, cold_dir=args.cold_dir,
                      admission=args.admission, half_life=args.half_life)
    params0 = ctr_lib.init(cfg, seed=args.seed, device=device)
    n_params = sum(int(x.numel()) for x in tree_leaves(params0))
    engine = (f"scan ({args.scan_steps} steps a graph)"
              if args.engine == "scan" else "eager")
    mode = ("stream (online, no epochs)" if args.mode == "stream"
            else "epochs")
    say(f"[train] {args.model}: {n_params/1e6:.1f}M params "
        f"({len(tr)} train rows, batch {args.batch}, rule {args.rule}, "
        f"embedding store {store.describe()}, engine {engine}, mode "
        f"{mode}, compute {args.compute_dtype}, device {device})")

    hp = scale_hyperparams(
        args.rule, base_lr=args.base_lr, base_l2=args.base_l2,
        base_batch=args.base_batch, batch_size=args.batch,
        base_dense_lr=2 * args.base_lr,
    )
    clip = "adaptive_column" if args.rule == "cowclip" else "none"
    warmup = max(1, len(tr) // args.batch)
    bundle = store.make_bundle(cfg, hp, clip_kind=clip, zeta=args.zeta,
                               warmup_steps=warmup,
                               nonfinite_guard=args.nonfinite_guard)

    # -- crash safety: snapshots, resume, deterministic fault injection --
    from ..testing import FaultPlan
    from ..train import snapshot as snapshot_lib

    fault_plan = FaultPlan.from_env()
    snap_mgr = None
    token = snapshot_lib.placement_token(store)
    start_step = 0
    init_state = None
    if args.snapshot_dir:
        snap_mgr = snapshot_lib.SnapshotManager(
            args.snapshot_dir, retain=args.snapshot_retain,
            fault_plan=fault_plan)
    if args.resume:
        # before the bundle's prepare: the async mmap resume replaces
        # --cold-dir with the snapshot's copy before the store opens it
        restored = snapshot_lib.resume(snap_mgr, bundle, params0,
                                       token=token, cold_dir=args.cold_dir,
                                       warn=say)
        if restored is None:
            say(f"[train] --resume: no valid snapshot under "
                f"{args.snapshot_dir}; starting fresh")
        else:
            p0, s0, start_step, cursor = restored
            init_state = (p0, s0)
            say(f"[train] resumed from snapshot step {start_step} "
                f"(cursor {cursor})")
    if init_state is None:
        params0 = bundle.prepare(params0)
        init_state = (params0, bundle.init(params0))
    del params0
    first = mesh is None or mesh.rank == 0   # the rank that writes
    snap_meta = {"placement": token, "snapshot_every": args.snapshot_every,
                 "seed": args.seed, "batch": args.batch}

    snapshot_cb = None
    if snap_mgr is not None or fault_plan is not None:
        # one callback a chunk boundary: snapshot when the cadence says so
        # (capture flushes; the pair it returns replaces the live one in
        # both the original and the resumed run, keeping them bitwise
        # aligned), then the fault plan's step-boundary kill window
        last_snap = [start_step]

        def snapshot_cb(params, state, n):
            if (snap_mgr is not None
                    and n - last_snap[0] >= args.snapshot_every):
                params, state = snapshot_lib.capture(
                    snap_mgr, bundle, params, state, step=n,
                    cursor={"rows_consumed": n * args.batch},
                    meta=snap_meta, write=first)
                last_snap[0] = n
            if fault_plan is not None:
                fault_plan.maybe_kill(n)
            return params, state

    segments = (args.mode == "stream" and snap_mgr is not None
                and bundle.stream_transform is not None)
    stream = None
    if args.mode == "stream" and not segments:
        stream = _make_stream(args, bundle, tr, start_step)

    trace_ctx = contextlib.nullcontext()
    if args.profile_trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        trace_ctx = torch.profiler.profile(activities=activities)
        say(f"[train] profiling to {args.profile_trace} (chrome trace)")
    with trace_ctx as prof:
        if segments:
            res = _run_async_segments(args, cfg, bundle, tr, te,
                                      *init_state, start_step, snap_mgr,
                                      snap_meta, fault_plan)
        else:
            res = train_ctr(cfg, None, tr, te, batch_size=args.batch,
                            epochs=args.epochs, seed=args.seed, log_fn=say,
                            step_bundle=bundle, max_steps=args.steps,
                            engine=args.engine, scan_steps=args.scan_steps,
                            mode=args.mode, stream=stream,
                            init_state=init_state, start_step=start_step,
                            snapshot_cb=snapshot_cb)
    if args.profile_trace and first:
        os.makedirs(args.profile_trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_trace,
                                              "trace.json"))
    say(f"[train] done: {res.steps} steps in {res.seconds:.1f}s "
        f"-> AUC {100*res.final_eval['auc']:.2f} "
        f"logloss {res.final_eval['logloss']:.4f}")
    if args.checkpoint:
        exported = bundle.export(res.params)   # every rank: a collective
    if args.checkpoint and first:
        checkpoint.save(args.checkpoint, {
            "params": exported,
            "final_eval": {k: np.asarray(v)
                           for k, v in res.final_eval.items()
                           if k in ("auc", "logloss")},
            "id_freq": {
                f"field_{i}": np.bincount(tr.ids[:, i], minlength=v)[:v]
                .astype(np.int64)
                for i, v in enumerate(cfg.vocab_sizes)},
        })
        say(f"[train] final params checkpointed to {args.checkpoint} "
            "(with id_freq for serving)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--task", choices=("ctr", "lm"), default="ctr")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; 'cpu' runs "
                         "the kernels' plain versions)")
    # ctr
    ap.add_argument("--model", default="deepfm",
                    choices=ctr_lib.MODEL_NAMES)
    ap.add_argument("--criteo", default=None, help="path to Criteo TSV")
    ap.add_argument("--max-rows", type=int, default=None)
    ap.add_argument("--samples", type=int, default=200_000)
    ap.add_argument("--vocab-scale", type=int, default=1,
                    help="multiply synthetic vocab sizes (86 ~ 100M params)")
    ap.add_argument("--emb-dim", type=int, default=10)
    ap.add_argument("--mlp-dim", type=int, default=400)
    ap.add_argument("--rule", default="cowclip", choices=RULES)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--base-batch", type=int, default=256)
    ap.add_argument("--base-lr", type=float, default=2e-2)
    ap.add_argument("--base-l2", type=float, default=1e-5)
    ap.add_argument("--zeta", type=float, default=1e-5)
    ap.add_argument("--placement", default=None, choices=PLACEMENT_CHOICES,
                    help="embedding store placement; 'fused' (the default "
                         "here). sharded_sparse = row-sharded tables with "
                         "per-shard unique-id updates; hotcold = a hot tier "
                         "beside the full tables, for --mode stream")
    ap.add_argument("--mode", default="epochs", choices=("epochs", "stream"),
                    help="'stream' trains online from an endless event stream "
                         "(no epochs; needs --steps)")
    ap.add_argument("--hot-capacity", type=int, default=4096,
                    help="hotcold placement: hot rows per field")
    ap.add_argument("--cold-store", default="none",
                    choices=("none", "mem", "mmap"),
                    help="hotcold placement: 'none' keeps the cold tier on "
                         "the device, in the step; 'mem'/'mmap' move it to "
                         "host memory / files under --cold-dir, planned one "
                         "step ahead (needs --mode stream)")
    ap.add_argument("--cold-dir", default=None, metavar="DIR",
                    help="--cold-store mmap: the table directory (reopening "
                         "it resumes)")
    ap.add_argument("--admission", default="cumulative",
                    choices=("cumulative", "decayed"),
                    help="hotcold placement: admission by cumulative or "
                         "decayed batch frequencies")
    ap.add_argument("--half-life", type=int, default=0,
                    help="--admission decayed: steps per halving")
    ap.add_argument("--sparse", action="store_true",
                    help="DEPRECATED alias for --placement sparse; errors "
                         "combined with another --placement")
    ap.add_argument("--unique-capacity", type=int, default=0,
                    help="sparse placement: padded per-field unique-id "
                         "capacity; <= 0 means the exact min(batch, vocab)")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="the grid of --placement sharded/sharded_sparse, "
                         "e.g. '2,4' = 2-way batch split x 4-way table "
                         "row-sharding; default (1, world size)")
    ap.add_argument("--partition", default="div", choices=("div", "mod"),
                    help="sharded row mapping: div = contiguous blocks, "
                         "mod = round-robin (balances Zipf-hot low ids)")
    ap.add_argument("--engine", default="scan", choices=("eager", "scan"),
                    help="training hot loop: 'scan' (default) captures "
                         "--scan-steps steps as one CUDA graph on the card "
                         "(runs them in turn on the CPU); 'eager' runs one "
                         "step per call")
    ap.add_argument("--scan-steps", type=int, default=8,
                    help="--engine scan: optimizer steps per captured "
                         "chunk")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="forward/backward activation dtype; masters, "
                         "CowClip stats and Adam moments stay float32")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="take periodic crash-safe snapshots into DIR "
                         "(atomic write + checksummed manifest, retain "
                         "--snapshot-retain); requires --mode stream and "
                         "--snapshot-every")
    ap.add_argument("--snapshot-every", type=int, default=0, metavar="N",
                    help="steps between snapshots; also the flush cadence, "
                         "so a resumed run is bitwise identical to an "
                         "uninterrupted run with the same value")
    ap.add_argument("--snapshot-retain", type=int, default=3,
                    help="keep the newest K snapshots (default 3)")
    ap.add_argument("--resume", action="store_true",
                    help="restart from the latest *valid* snapshot in "
                         "--snapshot-dir (corrupt/torn ones are skipped); "
                         "falls back to a fresh start when none exists")
    ap.add_argument("--nonfinite-guard", action="store_true",
                    help="skip any update whose batch loss is NaN/Inf "
                         "(counted in aux['skipped_steps']); value-exact "
                         "on clean data; not available with --cold-store "
                         "mem/mmap")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="sharded placements with --device cpu: spawn N gloo "
                         "CPU ranks, one a grid cell")
    ap.add_argument("--epochs", type=int, default=10)
    # lm
    ap.add_argument("--arch", default="gemma3-12b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=None,
                    help="optional hard cap on total CTR steps")
    # common
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--profile-trace", default=None, metavar="DIR",
                    help="write a torch.profiler chrome trace of the "
                         "training run to DIR/trace.json")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.task == "lm":
        from ..models.lm import NOT_PORTED_LM

        raise SystemExit("[train] --task lm is not ported to repro_torch "
                         f"yet: {NOT_PORTED_LM}")
    run_ctr(args)


if __name__ == "__main__":
    main()
