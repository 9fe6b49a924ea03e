"""CTR training driver for the PyTorch port.

The flags are those of ``repro.launch.train`` plus ``--device`` (default
``cuda``; without a CUDA device the run stops rather than train on the
CPU). The port trains ``--placement fused`` (the default here) and
``--placement sparse`` with the eager engine; the flags of paths not ported
yet exit with a message that names their ROADMAP item.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --task ctr \
      --placement fused --batch 8192 --epochs 2 --rule cowclip
  PYTHONPATH=src python -m repro_torch.launch.train --task ctr \
      --placement sparse --batch 8192 --epochs 2 --rule cowclip
  PYTHONPATH=src python -m repro_torch.launch.train --task ctr \
      --placement sparse --device cpu --samples 4096 --batch 512 --steps 2
"""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.scaling import RULES, scale_hyperparams
from ..core.tree import tree_leaves
from ..data import load_criteo_tsv, make_ctr_dataset
from ..embed.store import NOT_PORTED, store_for
from ..models import ctr as ctr_lib
from ..train import checkpoint, train_ctr

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


def _unported_flags(args, placement) -> list:
    """(flag, ROADMAP item) for every flag that asks for a path the port
    does not have yet."""
    out = []
    if placement in NOT_PORTED:
        out.append((f"--placement {placement}", NOT_PORTED[placement]))
    if args.engine == "scan":
        out.append(("--engine scan",
                    "ROADMAP queue 1 item 3 (the CUDA-graph engine)"))
    if args.mode == "stream" or args.cold_store != "none":
        out.append(("--mode stream / --cold-store",
                    "ROADMAP queue 1 item 5 (streaming and hot/cold tiers)"))
    if args.snapshot_dir or args.resume:
        out.append(("--snapshot-dir / --resume",
                    "ROADMAP queue 1 item 6 (durability)"))
    if args.host_devices:
        out.append(("--host-devices",
                    "ROADMAP queue 1 item 7 (multi-GPU placements)"))
    return out


def run_ctr(args) -> None:
    placement = resolve_placement(args.placement, args.sparse)
    missing = _unported_flags(args, placement)
    if missing:
        raise SystemExit("[train] not ported to repro_torch yet: " + "; ".join(
            f"{flag} -> {item}" for flag, item in missing))
    device = resolve_device(args.device)

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
    store = store_for(cfg)
    params0 = ctr_lib.init(cfg, seed=args.seed, device=device)
    n_params = sum(int(x.numel()) for x in tree_leaves(params0))
    print(f"[train] {args.model}: {n_params/1e6:.1f}M params "
          f"({len(tr)} train rows, batch {args.batch}, rule {args.rule}, "
          f"embedding store {store.describe()}, engine eager, mode epochs, "
          f"compute {args.compute_dtype}, device {device})")

    hp = scale_hyperparams(
        args.rule, base_lr=args.base_lr, base_l2=args.base_l2,
        base_batch=args.base_batch, batch_size=args.batch,
        base_dense_lr=2 * args.base_lr,
    )
    warmup = max(1, len(tr) // args.batch)
    bundle = store.make_bundle(cfg, hp, zeta=args.zeta, warmup_steps=warmup,
                               nonfinite_guard=args.nonfinite_guard)
    params0 = bundle.prepare(params0)

    trace_ctx = contextlib.nullcontext()
    if args.profile_trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        trace_ctx = torch.profiler.profile(activities=activities)
        print(f"[train] profiling to {args.profile_trace} (chrome trace)")
    with trace_ctx as prof:
        res = train_ctr(cfg, None, tr, te, batch_size=args.batch,
                        epochs=args.epochs, seed=args.seed, log_fn=print,
                        step_bundle=bundle, max_steps=args.steps,
                        init_state=(params0, bundle.init(params0)))
    if args.profile_trace:
        os.makedirs(args.profile_trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_trace,
                                              "trace.json"))
    print(f"[train] done: {res.steps} steps in {res.seconds:.1f}s "
          f"-> AUC {100*res.final_eval['auc']:.2f} "
          f"logloss {res.final_eval['logloss']:.4f}")
    if args.checkpoint:
        checkpoint.save(args.checkpoint, {
            "params": bundle.export(res.params),
            "final_eval": {k: np.asarray(v)
                           for k, v in res.final_eval.items()
                           if k in ("auc", "logloss")},
            "id_freq": {
                f"field_{i}": np.bincount(tr.ids[:, i], minlength=v)[:v]
                .astype(np.int64)
                for i, v in enumerate(cfg.vocab_sizes)},
        })
        print(f"[train] final params checkpointed to {args.checkpoint} "
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
                         "here) and 'sparse' are ported so far")
    ap.add_argument("--mode", default="epochs", choices=("epochs", "stream"),
                    help="'stream' is not ported yet")
    ap.add_argument("--hot-capacity", type=int, default=4096,
                    help="hotcold placement only (not ported yet)")
    ap.add_argument("--cold-store", default="none",
                    choices=("none", "mem", "mmap"),
                    help="hotcold placement only (not ported yet)")
    ap.add_argument("--cold-dir", default=None, metavar="DIR",
                    help="hotcold placement only (not ported yet)")
    ap.add_argument("--admission", default="cumulative",
                    choices=("cumulative", "decayed"),
                    help="hotcold placement only (not ported yet)")
    ap.add_argument("--half-life", type=int, default=0,
                    help="hotcold placement only (not ported yet)")
    ap.add_argument("--sparse", action="store_true",
                    help="DEPRECATED alias for --placement sparse; errors "
                         "combined with another --placement")
    ap.add_argument("--unique-capacity", type=int, default=0,
                    help="sparse placement: padded per-field unique-id "
                         "capacity; <= 0 means the exact min(batch, vocab)")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="sharded placements only (not ported yet)")
    ap.add_argument("--partition", default="div", choices=("div", "mod"),
                    help="sharded placements only (not ported yet)")
    ap.add_argument("--engine", default="eager", choices=("eager", "scan"),
                    help="training hot loop; 'eager' (the default here) "
                         "runs one step per call, 'scan' is not ported yet")
    ap.add_argument("--scan-steps", type=int, default=8,
                    help="--engine scan only (not ported yet)")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="forward/backward activation dtype; masters, "
                         "CowClip stats and Adam moments stay float32")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="not ported yet")
    ap.add_argument("--snapshot-every", type=int, default=0, metavar="N",
                    help="not ported yet")
    ap.add_argument("--snapshot-retain", type=int, default=3,
                    help="not ported yet")
    ap.add_argument("--resume", action="store_true", help="not ported yet")
    ap.add_argument("--nonfinite-guard", action="store_true",
                    help="skip any update whose batch loss is NaN/Inf "
                         "(counted in aux['skipped_steps'])")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="not ported yet (multi-GPU placements)")
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
        raise SystemExit("[train] --task lm is not ported to repro_torch "
                         "yet: ROADMAP queue 1 item 8 (the LM side)")
    run_ctr(args)


if __name__ == "__main__":
    main()
