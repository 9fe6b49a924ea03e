"""Batched greedy decoding of an RWKV-6 LM: the port's counterpart of
``examples/serve_decode.py``.

``greedy_generate`` runs the serving prefill (``lm.prefill_with_cache``,
which fills every layer's recurrent state, eagerly, through the wkv6
kernel), then one ``lm.decode_step`` per new token with argmax sampling,
as that script's loop does. The reference jits that step; here, on the
card, it is captured once per batch size as a CUDA graph over a static
token buffer and a static cache that the step writes in place
(``DecodeGraph``), and each new token is one replay.

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
from typing import NamedTuple, Optional

import torch

from ..configs import get_config, reduce_config
from ..core.device import resolve_device
from ..core.tree import tree_leaves, tree_map
from ..models import lm


class Generation(NamedTuple):
    tokens: torch.Tensor          # [B, new_tokens] generated ids
    prefill_logits: torch.Tensor  # [B, V_padded] f32, the prompt's last position
    logits: torch.Tensor          # [B, V_padded] f32, after the last decode step


class DecodeGraph:
    """``lm.decode_step`` and its argmax captured as one CUDA graph for
    one batch size: a replay reads the static ``tokens`` [B] and ``cache``,
    writes the new state into ``cache`` in place, the next-token logits
    into ``logits`` and their argmax back into ``tokens``. The step is
    warmed up once on a side stream (out of place, so nothing static
    moves) and then captured; a capture that fails raises."""

    def __init__(self, params: dict, cfg: lm.LMConfig, batch: int):
        from ..kernels.extension import build

        device = tree_leaves(params)[0].device
        build()
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.inference_mode():
            self.tokens = torch.zeros(batch, dtype=torch.int64,
                                      device=device)
            self.cache = lm.init_cache(cfg, batch, 0, device=device)
            with torch.cuda.stream(stream):
                lm.decode_step(params, cfg, self.tokens, self.cache, 0)
            torch.cuda.current_stream(device).wait_stream(stream)
            torch.cuda.synchronize(device)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=stream):
                self.logits, _ = lm.decode_step(params, cfg, self.tokens,
                                                self.cache, 0, inplace=True)
                self.tokens.copy_(torch.argmax(self.logits, dim=-1))

    def start(self, tokens: torch.Tensor, cache: dict) -> None:
        """Load the first tokens to feed and the prefill's cache."""
        with torch.inference_mode():
            self.tokens.copy_(tokens)
            tree_map(lambda dst, src: dst.copy_(src), self.cache, cache)

    def step(self) -> torch.Tensor:
        """One decode step: returns the tokens it fed (a copy), and leaves
        the next ones in ``tokens`` and their logits in ``logits``."""
        fed = self.tokens.clone()
        self.graph.replay()
        return fed


class GraphDecoder:
    """The ``DecodeGraph`` of each batch size a model has decoded at,
    captured at its first use."""

    def __init__(self, params: dict, cfg: lm.LMConfig):
        self.params, self.cfg = params, cfg
        self.graphs: dict = {}

    def graph(self, batch: int) -> DecodeGraph:
        if batch not in self.graphs:
            self.graphs[batch] = DecodeGraph(self.params, self.cfg, batch)
        return self.graphs[batch]


def greedy_generate(params: dict, cfg: lm.LMConfig, prompt: torch.Tensor,
                    new_tokens: int, *,
                    decoder: Optional[GraphDecoder] = None,
                    graph: bool = True) -> Generation:
    """Greedy continuation of ``prompt`` [B, P] by ``new_tokens`` tokens.
    Like the reference loop, every generated token is fed back through
    ``decode_step``, the last one included. On the card each decode step
    is a replay of ``decoder``'s graph for B (a new ``GraphDecoder`` when
    None); ``graph=False``, and the CPU, run the steps eagerly. Both give
    the same tokens and logits."""
    max_len = prompt.shape[1] + new_tokens
    with torch.inference_mode():
        first, cache, cur = lm.prefill_with_cache(params, cfg, prompt,
                                                  max_len)
    logits = first
    tok = torch.argmax(logits, dim=-1)
    out = []
    if graph and prompt.device.type == "cuda" and new_tokens > 0:
        dec = (decoder or GraphDecoder(params, cfg)).graph(prompt.shape[0])
        dec.start(tok, cache)
        out = [dec.step() for _ in range(cur, max_len)]
        logits = dec.logits.clone()
    else:
        with torch.inference_mode():
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
