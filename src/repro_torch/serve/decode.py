"""Batched greedy decoding of an LM: the port's counterpart of
``examples/serve_decode.py``.

``greedy_generate`` runs the serving prefill (``lm.prefill_with_cache``,
which fills every layer's KV cache or recurrent state, eagerly), then one
``lm.decode_step`` per new token with argmax sampling, as that script's
loop does. The reference jits that step; here, on the card, it is
captured once per batch size (and ``max_len``, where the model has a KV
cache: an attention layer's, or zamba2's shared rings) as a CUDA graph over a static token buffer, a static cache that
the step writes in place and a cursor on the card that it advances
(``DecodeGraph``), and each new token is one replay.

    PYTHONPATH=src python -m repro_torch.serve.decode --device cpu
    PYTHONPATH=src python -m repro_torch.serve.decode --arch gemma3-12b \
        --device cpu
    PYTHONPATH=src python -m repro_torch.serve.decode --arch zamba2-2.7b \
        --device cpu

run an arch's reduced config (2 or 4 layers, d_model 128, f32; MoE at 4
experts) on the CPU; without ``--device`` they run on the card and refuse
to start without one. ``--arch`` takes all ten LM archs
(``configs.ASSIGNED_ARCHS``); musicgen-large and internvl2-26b get a
seeded ``[B, n_prefix, d_model]`` frontend prefix.
``--wkv-backend`` picks rwkv6-7b's sequence scan of both prefills (the
cached one and the score-only one the script also runs): ``chunked`` (the
wkv6 kernel on the card) or ``scan``.
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
    one batch size and, where the model has a KV cache, one ``max_len``: a
    replay reads the static ``tokens`` [B], ``cache`` and ``cursor`` (a
    0-dim int64 on the card: the tokens already cached), writes the new
    state into ``cache`` in place, the next-token logits into ``logits``,
    their argmax back into ``tokens``, and adds one to ``cursor``. The step
    is warmed up once on a side stream (out of place, so nothing static
    moves) and then captured; a capture that fails raises."""

    def __init__(self, params: dict, cfg: lm.LMConfig, batch: int,
                 max_len: int):
        from ..kernels.extension import build

        device = tree_leaves(params)[0].device
        build()
        self.kv = lm.has_kv_cache(cfg)
        self.max_len = max_len
        self.position = 0     # the host's count of the cursor, for bounds
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.inference_mode():
            self.tokens = torch.zeros(batch, dtype=torch.int64,
                                      device=device)
            self.cursor = torch.zeros((), dtype=torch.int64, device=device)
            self.cache = lm.init_cache(cfg, batch, max_len, device=device)
            with torch.cuda.stream(stream):
                lm.decode_step(params, cfg, self.tokens, self.cache,
                               self.cursor)
            torch.cuda.current_stream(device).wait_stream(stream)
            torch.cuda.synchronize(device)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=stream):
                self.logits, _ = lm.decode_step(params, cfg, self.tokens,
                                                self.cache, self.cursor,
                                                inplace=True)
                self.tokens.copy_(torch.argmax(self.logits, dim=-1))
                self.cursor.add_(1)

    def start(self, tokens: torch.Tensor, cache: dict,
              cur_index: int) -> None:
        """Load the first tokens to feed, the prefill's cache and its
        ``cur_index``."""
        with torch.inference_mode():
            self.tokens.copy_(tokens)
            tree_map(lambda dst, src: dst.copy_(src), self.cache, cache)
            self.cursor.fill_(cur_index)
        self.position = cur_index

    def step(self) -> torch.Tensor:
        """One decode step: returns the tokens it fed (a copy), and leaves
        the next ones in ``tokens`` and their logits in ``logits``."""
        if self.kv and self.position >= self.max_len:
            raise ValueError(f"decode past max_len {self.max_len}: the KV "
                             "cache has no slot for the token")
        fed = self.tokens.clone()
        self.graph.replay()
        self.position += 1
        return fed


class GraphDecoder:
    """The ``DecodeGraph`` of each batch size (and, with a KV cache, each
    ``max_len``) a model has decoded at, captured at its first use."""

    def __init__(self, params: dict, cfg: lm.LMConfig):
        self.params, self.cfg = params, cfg
        self.graphs: dict = {}

    def key(self, batch: int, max_len: int) -> tuple:
        """A recurrent state is the same at every ``max_len``."""
        return batch, max_len if lm.has_kv_cache(self.cfg) else None

    def graph(self, batch: int, max_len: int) -> DecodeGraph:
        key = self.key(batch, max_len)
        if key not in self.graphs:
            self.graphs[key] = DecodeGraph(self.params, self.cfg, batch,
                                           key[1] or 0)
        return self.graphs[key]


def frontend_prefix(cfg: lm.LMConfig, batch: int, *, seed: int = 0,
                    device="cuda") -> Optional[torch.Tensor]:
    """Seeded frontend embeddings [B, n_prefix, d_model] (audio frames or
    vision patches, 0.1 x a standard normal, f32) for an arch with a
    frontend; None for one without."""
    if not cfg.frontend:
        return None
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return 0.1 * torch.randn((batch, cfg.n_prefix, cfg.d_model),
                             generator=gen, device=device)


def greedy_generate(params: dict, cfg: lm.LMConfig, prompt: torch.Tensor,
                    new_tokens: int, *,
                    prefix_emb: Optional[torch.Tensor] = None,
                    decoder: Optional[GraphDecoder] = None,
                    graph: bool = True) -> Generation:
    """Greedy continuation of ``prompt`` [B, S] (after the frontend's
    ``prefix_emb`` [B, P, D], if any) by ``new_tokens`` tokens. Like the
    reference loop, every generated token is fed back through
    ``decode_step``, the last one included. On the card each decode step
    is a replay of ``decoder``'s graph for (B, P + S + new_tokens) (a new
    ``GraphDecoder`` when None); ``graph=False``, and the CPU, run the
    steps eagerly, in place on the prefill's cache. Both give the same
    tokens and logits."""
    p = 0 if prefix_emb is None else prefix_emb.shape[1]
    max_len = p + prompt.shape[1] + new_tokens
    with torch.inference_mode():
        first, cache, cur = lm.prefill_with_cache(params, cfg, prompt,
                                                  max_len, prefix_emb)
    logits = first
    tok = torch.argmax(logits, dim=-1)
    out = []
    if graph and prompt.device.type == "cuda" and new_tokens > 0:
        dec = (decoder or GraphDecoder(params, cfg)).graph(prompt.shape[0],
                                                           max_len)
        dec.start(tok, cache, cur)
        out = [dec.step() for _ in range(cur, max_len)]
        logits = dec.logits.clone()
    else:
        with torch.inference_mode():
            for t in range(cur, max_len):
                out.append(tok)
                logits, cache = lm.decode_step(params, cfg, tok, cache, t,
                                               inplace=True)
                tok = torch.argmax(logits, dim=-1)
    tokens = (torch.stack(out, dim=1) if out else
              torch.zeros((prompt.shape[0], 0), dtype=torch.int64,
                          device=prompt.device))
    return Generation(tokens, first, logits)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="rwkv6-7b",
                    help="an LM arch id (configs.ASSIGNED_ARCHS), run at "
                         "its reduced size")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernel's plain version)")
    ap.add_argument("--wkv-backend", default="chunked",
                    choices=("chunked", "scan"),
                    help="sequence scan of rwkv6-7b's prefills")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = dataclasses.replace(reduce_config(get_config(args.arch)),
                              wkv_backend=args.wkv_backend)
    print(f"serving {cfg.name} (reduced): pattern={cfg.block_pattern}, "
          f"d_model={cfg.d_model}, wkv_backend={cfg.wkv_backend}, "
          f"prefix={cfg.n_prefix if cfg.frontend else 0}, device={device}")
    params = lm.init(cfg, seed=args.seed, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    prefix = frontend_prefix(cfg, args.batch, seed=args.seed + 2,
                             device=device)

    with torch.inference_mode():
        scored = lm.prefill(params, cfg, prompt, prefix)
    t0 = time.perf_counter()
    res = greedy_generate(params, cfg, prompt, args.new_tokens,
                          prefix_emb=prefix)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    gap = (scored - res.prefill_logits).abs().max().item()
    print(f"score-only vs cached prefill: max |logits diff| {gap:.3e}")
    print(f"generated {tuple(res.tokens.shape)} tokens: "
          f"{res.tokens[0][:16].tolist()} ...")
    print(f"{args.batch * args.new_tokens} tokens in {dt:.2f}s -> "
          f"{args.batch * args.new_tokens / dt:.1f} generated tok/s "
          f"({device}, reduced)")
    if not (torch.isfinite(res.logits).all() and torch.isfinite(scored).all()):
        raise SystemExit("non-finite logits")


if __name__ == "__main__":
    main()
