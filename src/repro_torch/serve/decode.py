"""Batched greedy decoding of an RWKV-6 LM: the port's counterpart of
``examples/serve_decode.py``.

``greedy_generate`` runs the serving prefill (``lm.prefill_with_cache``,
which fills every layer's recurrent state), then one ``lm.decode_step``
per new token with argmax sampling, as that script's loop does.

    PYTHONPATH=src python -m repro_torch.serve.decode --device cpu

runs the reduced config (2 layers, d_model 128, f32) on the CPU; without
``--device`` it runs on the card and refuses to start without one.
``--wkv-backend`` picks the sequence scan of both prefills (the cached
one and the score-only one the script also runs): ``chunked`` (the wkv6
kernel on the card) or ``scan``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import NamedTuple

import torch

from ..configs import get_config, reduce_config
from ..core.device import resolve_device
from ..models import lm


class Generation(NamedTuple):
    tokens: torch.Tensor          # [B, new_tokens] generated ids
    prefill_logits: torch.Tensor  # [B, V_padded] f32, the prompt's last position
    logits: torch.Tensor          # [B, V_padded] f32, after the last decode step


def greedy_generate(params: dict, cfg: lm.LMConfig, prompt: torch.Tensor,
                    new_tokens: int) -> Generation:
    """Greedy continuation of ``prompt`` [B, P] by ``new_tokens`` tokens.
    Like the reference loop, every generated token is fed back through
    ``decode_step``, the last one included."""
    max_len = prompt.shape[1] + new_tokens
    with torch.inference_mode():
        first, cache, cur = lm.prefill_with_cache(params, cfg, prompt,
                                                  max_len)
        logits = first
        tok = torch.argmax(logits, dim=-1)
        out = []
        for t in range(cur, max_len):
            out.append(tok)
            logits, cache = lm.decode_step(params, cfg, tok, cache, t)
            tok = torch.argmax(logits, dim=-1)
    tokens = (torch.stack(out, dim=1) if out else
              torch.zeros((prompt.shape[0], 0), dtype=torch.int64,
                          device=prompt.device))
    return Generation(tokens, first, logits)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="rwkv6-7b",
                    help="LM arch id; only rwkv6-7b is ported")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernel's plain version)")
    ap.add_argument("--wkv-backend", default="chunked",
                    choices=("chunked", "scan"),
                    help="sequence scan of the prefills")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = dataclasses.replace(reduce_config(get_config(args.arch)),
                              wkv_backend=args.wkv_backend)
    print(f"serving {cfg.name} (reduced): pattern={cfg.block_pattern}, "
          f"d_model={cfg.d_model}, wkv_backend={cfg.wkv_backend}, "
          f"device={device}")
    params = lm.init(cfg, seed=args.seed, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)

    with torch.inference_mode():
        scored = lm.prefill(params, cfg, prompt)
    t0 = time.perf_counter()
    res = greedy_generate(params, cfg, prompt, args.new_tokens)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    gap = (scored - res.prefill_logits).abs().max().item()
    print(f"score-only vs cached prefill ({cfg.wkv_backend}): "
          f"max |logits diff| {gap:.3e}")
    print(f"generated {tuple(res.tokens.shape)} tokens: "
          f"{res.tokens[0][:16].tolist()} ...")
    print(f"{args.batch * args.new_tokens} tokens in {dt:.2f}s -> "
          f"{args.batch * args.new_tokens / dt:.1f} generated tok/s "
          f"({device}, reduced)")
    if not (torch.isfinite(res.logits).all() and torch.isfinite(scored).all()):
        raise SystemExit("non-finite logits")


if __name__ == "__main__":
    main()
