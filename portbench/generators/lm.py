"""Inputs of an LM training cell, made from the seed on the run's device.

``make_tokens`` draws a token stream by the law of the port's own
``repro_torch.data.synthetic.make_lm_tokens``: Zipf(a) over the vocab
behind a random permutation of the ids (word frequencies are Zipfian,
the paper's closing point about NLP tables). A step reads the next
``[batch, seq]`` slice of consecutive tokens, as ``train_lm`` does, and
the stream restarts at its end.

``make_weights`` draws the RWKV-6 model's starting weights in the port's
tree layout (layers stacked on a leading axis), f32 on the card, as the
port's ``lm.init`` lays them out: N(0, scale) matrices drawn in three
large draws (the token table, the output head, every layer's matrices
together) and viewed leaf by leaf, and the constant leaves filled.
"""

from __future__ import annotations

import math

import torch

from ..seeds import generator


def make_tokens(traffic: dict, config: dict, seed: int, device):
    """``[slices, batch, seq]`` int32 tokens on ``device``."""
    vocab = config["vocab_size"]
    b, s = traffic["batch"], traffic["seq"]
    n = traffic["slices"] * b * s
    gen = generator(seed, "traffic", device)
    dev = torch.device(device)
    p = torch.arange(1, vocab + 1, device=dev, dtype=torch.float64) ** (
        -traffic["zipf_a"])
    cdf = torch.cumsum(p / p.sum(), 0)
    raw = torch.searchsorted(cdf, torch.rand(n, generator=gen, device=dev,
                                             dtype=torch.float64),
                             right=True).clamp_max(vocab - 1)
    perm = torch.randperm(vocab, generator=gen, device=dev)
    return perm[raw].to(torch.int32).view(traffic["slices"], b, s)


def padded_vocab(config: dict) -> int:
    return -(-config["vocab_size"] // 256) * 256


def rwkv6_shapes(config: dict) -> list:
    """``[(path, shape, scale)]`` of the normal-drawn matrices of one
    RWKV-6 position, stacked over the layers (``lm.init``'s scales)."""
    L, d, f = config["n_layers"], config["d_model"], config["d_ff"]
    r = config["decay_rank"]
    s = 1.0 / math.sqrt(d)
    att = [(f"att.{k}", (L, d, d), s) for k in ("wr", "wk", "wv", "wg",
                                                 "wo")]
    att += [("att.wA", (L, d, r), s), ("att.wB", (L, r, d), 0.01),
            ("att.u", (L, d), 0.1)]
    ffn = [("ffn.wk", (L, d, f), s), ("ffn.wv", (L, f, d), 1 / math.sqrt(f)),
           ("ffn.wr", (L, d, d), s)]
    return att + ffn


def make_weights(config: dict, seed: int, device) -> dict:
    """``{"embed": {"tokens"}, "dense": {"blocks": {"pos_0": {...}},
    "final_norm", "head"}}``, every leaf f32."""
    L, d = config["n_layers"], config["d_model"]
    n = d // config["n_heads"]
    vocab = padded_vocab(config)
    gen = generator(seed, "weights", device)
    dev = torch.device(device)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    tokens = torch.randn(vocab, d, generator=gen, device=dev).mul_(
        config["emb_sigma"])
    head = torch.randn(d, vocab, generator=gen, device=dev).mul_(
        1.0 / math.sqrt(d))
    shapes = rwkv6_shapes(config)
    flat = torch.randn(sum(math.prod(sh) for _, sh, _ in shapes),
                       generator=gen, device=dev)
    pos = {"norm1": {"scale": full((L, d), 1.0)},
           "att": {f"mix_{k}": full((L, d), 0.5) for k in "rkvwg"},
           "norm2": {"scale": full((L, d), 1.0)},
           "ffn": {"mix_k": full((L, d), 0.5), "mix_r": full((L, d), 0.5)}}
    pos["att"]["w0"] = full((L, d), -0.6)
    pos["att"]["ln_scale"] = full((L, config["n_heads"], n), 1.0)
    at = 0
    for path, shape, scale in shapes:
        size = math.prod(shape)
        group, name = path.split(".")
        pos[group][name] = flat[at:at + size].view(shape).mul_(scale)
        at += size
    dense = {"blocks": {"pos_0": pos},
             "final_norm": {"scale": full((d,), 1.0)}, "head": head}
    return {"embed": {"tokens": tokens}, "dense": dense}
