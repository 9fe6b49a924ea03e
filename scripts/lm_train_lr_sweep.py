"""The losses of ``chip_smoke.py``'s LM training runs at several
``--base-lr``.

    python scripts/lm_train_lr_sweep.py [--arch rwkv6-7b]
                                        [--lrs 2.5e-4,1e-4,5e-5,2.5e-5]
                                        [--layers N] [--batch 8x512]
                                        [--steps 10]

An LM arch at full width (``--arch``: rwkv6-7b, phase 48's, with its depth
cut to ``--layers``, 8 by default; zamba2-2.7b, phase 52's, at its own
depth unless ``--layers`` is given), bf16 compute (rwkv6's wkv6 chunked),
``--batch`` B x S tokens of the CLI's token stream (``--samples``'
default, seed 0; phase 48's 8 x 512, phase 52's 2 x 512), through
``train.loop.train_lm``, the loop of ``python -m repro_torch.launch.train
--task lm``: one run of ``--steps`` steps a learning rate, each step's
loss printed. Needs one card.
"""

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import build_parser  # noqa: E402
from repro_torch.train.loop import train_lm  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="rwkv6-7b",
                    choices=("rwkv6-7b", "zamba2-2.7b"))
    ap.add_argument("--lrs", default="2.5e-4,1e-4,5e-5,2.5e-5")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", default="8x512")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lm_train_lr_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.arch == "rwkv6-7b":
        cfg = dataclasses.replace(cfg, n_layers=args.layers or 8,
                                  wkv_backend="chunked")
    elif args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    batch, seq = (int(x) for x in args.batch.split("x"))
    samples = build_parser().get_default("samples")
    print(f"{torch.cuda.get_device_name(0)}; {args.arch} at {cfg.n_layers} "
          f"layers, batch {batch} x {seq}, {args.steps} steps", flush=True)
    for lr in (float(x) for x in args.lrs.split(",")):
        out = train_lm(cfg, batch=batch, seq=seq, steps=args.steps,
                       base_lr=lr, base_l2=1e-5, samples=samples, seed=0,
                       device="cuda")
        print(f"--base-lr {lr}: losses "
              f"{[round(x, 4) for x in out.losses.tolist()]}", flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
