"""The losses of ``chip_smoke.py`` phase 48's run at several ``--base-lr``.

    python scripts/lm_train_lr_sweep.py [--lrs 2.5e-4,1e-4,5e-5,2.5e-5]
                                        [--layers 8] [--steps 10]

rwkv6-7b at full width with its depth cut to ``--layers``, bf16 compute,
wkv6 chunked, batch 8 x 512 of the CLI's token stream (``--samples``'
default, seed 0), through ``train.loop.train_lm``, the loop of ``python
-m repro_torch.launch.train --task lm``: one run of ``--steps`` steps a
learning rate, each step's loss printed. Needs one card.
"""

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.rwkv6_7b import CONFIG  # noqa: E402
from repro_torch.launch.train import build_parser  # noqa: E402
from repro_torch.train.loop import train_lm  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--lrs", default="2.5e-4,1e-4,5e-5,2.5e-5")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lm_train_lr_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(CONFIG, n_layers=args.layers,
                              wkv_backend="chunked")
    samples = build_parser().get_default("samples")
    print(f"{torch.cuda.get_device_name(0)}; rwkv6-7b at {args.layers} "
          f"layers, batch 8 x 512, {args.steps} steps", flush=True)
    for lr in (float(x) for x in args.lrs.split(",")):
        out = train_lm(cfg, batch=8, seq=512, steps=args.steps, base_lr=lr,
                       base_l2=1e-5, samples=samples, seed=0, device="cuda")
        print(f"--base-lr {lr}: losses "
              f"{[round(x, 4) for x in out.losses.tolist()]}", flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
