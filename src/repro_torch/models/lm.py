"""Decoder LM assembled from a config, as in ``repro.models.lm``; the port
runs its RWKV-6 configurations (``block_pattern`` of ``"rwkv6"`` only).

* **Stacked superblocks.** Layers are grouped into a repeating
  ``block_pattern``; every leaf of ``params["dense"]["blocks"]["pos_i"]``
  is stacked ``[n_repeats, ...]`` exactly as the reference's ``jax.vmap``
  stacks it, so the ``/``-keyed npz of ``train/checkpoint.py`` carries LM
  params across unchanged. The reference's ``jax.lax.scan`` over
  superblocks is a Python loop indexing the stacked leaves.
* **Two-group params.** ``{"embed": {"tokens": [V, D]}, "dense": ...}``.
* **Decode states.** O(1) recurrent ``RWKVState`` per layer, stacked per
  superblock like the params.
* **Cast points** are the reference's: the embedding is cast to the
  compute dtype, the mixers run in it with weights cast at use (the decay
  and the wkv scan in f32), norms accumulate in f32, logits are cast to
  ``logits_dtype``.

The ``attn``/``local``/``mamba2`` kinds, MoE, ``shared_attn`` and the
frontends raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..core.device import resolve_device
from ..core.tree import tree_leaves, tree_map
from . import layers, rwkv

NOT_PORTED_LM = "ROADMAP queue 1 item 8 (the rest of the LM side)"


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    arch_type: str                    # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    block_pattern: tuple = ("attn",)
    window: Optional[int] = None      # sliding-window width for 'local'
    moe: Optional[Any] = None         # MoE config (not ported)
    ssm_state: int = 64
    mamba_head_dim: int = 64
    shared_attn: bool = False         # zamba2: shared attn+mlp per superblock
    frontend: Optional[str] = None    # 'audio' | 'vision'
    n_prefix: int = 0
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    act: str = "swiglu"
    emb_sigma: float = 1e-2
    compute_dtype: str = "bfloat16"
    remat: bool = False
    remat_policy: str = "full"  # "full" | "dots" (save matmul outputs)
    wkv_backend: str = "scan"   # "scan" | "chunked" (the wkv6 kernel)
    logits_dtype: str = "float32"   # "bfloat16": keep logits in compute dtype
    scan_unroll: bool = False   # unroll the layer scan (FLOP-accounting runs)
    pad_attn_heads: int = 0     # pad query heads to this multiple for TP
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_heads_alloc(self) -> int:
        if not self.pad_attn_heads:
            return self.n_heads
        m = self.pad_attn_heads
        # keep GQA grouping valid: alloc must stay a multiple of kv heads
        alloc = ((self.n_heads + m - 1) // m) * m
        return math.lcm(alloc, self.n_kv_heads) if alloc % self.n_kv_heads \
            else alloc

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256; logits beyond
        ``vocab_size`` are masked in the loss/decode."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def n_repeats(self) -> int:
        if self.n_layers % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {len(self.block_pattern)}"
            )
        return self.n_layers // len(self.block_pattern)

    @property
    def dtype(self) -> torch.dtype:
        return _torch_dtype(self.compute_dtype)

    def validate(self) -> "LMConfig":
        for kind in self.block_pattern:
            if kind not in ("attn", "local", "rwkv6", "mamba2"):
                raise ValueError(f"unknown block kind {kind!r}")
        if "local" in self.block_pattern and not self.window:
            raise ValueError("'local' blocks require window")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        return self


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _require_ported(cfg: LMConfig) -> None:
    cfg.validate()
    other = sorted(set(cfg.block_pattern) - {"rwkv6"})
    what = (f"block kinds {other}" if other else
            "MoE" if cfg.moe is not None else
            "shared_attn" if cfg.shared_attn else
            f"the {cfg.frontend!r} frontend" if cfg.frontend else None)
    if what:
        raise NotImplementedError(
            f"{cfg.name}: {what} not ported to repro_torch yet: "
            f"{NOT_PORTED_LM}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_position(gen, kind: str, cfg: LMConfig, device) -> dict:
    """Params of one layer position, stacked ``[n_repeats, ...]``."""
    d, lead = cfg.d_model, (cfg.n_repeats,)
    if kind == "rwkv6":
        return {
            "norm1": layers.init_rmsnorm(d, lead=lead, device=device),
            "att": rwkv.init_rwkv6(gen, d, cfg.n_heads, lead=lead,
                                   device=device),
            "norm2": layers.init_rmsnorm(d, lead=lead, device=device),
            "ffn": rwkv.init_channel_mix(gen, d, cfg.d_ff, lead=lead,
                                         device=device),
        }
    raise NotImplementedError(f"block kind {kind!r}: {NOT_PORTED_LM}")


def init(cfg: LMConfig, *, generator: torch.Generator | None = None,
         seed: int = 0, device="cuda") -> dict:
    """Random params for ``cfg`` on ``device`` (f32), drawn from
    ``generator`` (a fresh one seeded with ``seed`` when None). On the
    card the values are drawn there; ``device="meta"`` allocates
    nothing."""
    _require_ported(cfg)
    device = (torch.device("meta") if str(device) == "meta"
              else resolve_device(device))
    if generator is None:
        generator = torch.Generator(
            device="cpu" if device.type == "meta" else device
        ).manual_seed(seed)
    embed = {"tokens": rwkv._normal(generator,
                                    (cfg.padded_vocab, cfg.d_model),
                                    cfg.emb_sigma, device)}
    dense: dict = {"blocks": {
        f"pos_{i}": _init_position(generator, kind, cfg, device)
        for i, kind in enumerate(cfg.block_pattern)}}
    dense["final_norm"] = layers.init_rmsnorm(cfg.d_model, device=device)
    dense["head"] = rwkv._normal(generator, (cfg.d_model, cfg.padded_vocab),
                                 1.0 / math.sqrt(cfg.d_model), device)
    return {"embed": embed, "dense": dense}


def _repeat(tree, i: int):
    """Superblock ``i`` of a tree stacked ``[n_repeats, ...]``."""
    return tree_map(lambda t: t[i], tree)


def _stack(trees: list):
    return tree_map(lambda *ts: torch.stack(ts), *trees)


def _embed(params, cfg: LMConfig, tokens):
    return params["embed"]["tokens"][tokens].to(cfg.dtype)


def _shift(h):
    """h shifted right by one token (zeros first)."""
    return torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)


def _no_prefix(prefix_emb) -> None:
    if prefix_emb is not None:
        raise NotImplementedError(f"frontend prefix embeddings: "
                                  f"{NOT_PORTED_LM}")


# ---------------------------------------------------------------------------
# forward (training / scoring)
# ---------------------------------------------------------------------------


def _apply_position(p, kind: str, cfg: LMConfig, x, aux):
    """One layer forward over a full sequence."""
    if kind == "rwkv6":
        x = x + rwkv.rwkv6_train(
            p["att"], layers.rmsnorm(p["norm1"], x, cfg.norm_eps),
            n_heads=cfg.n_heads, backend=cfg.wkv_backend,
        )
        h = layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
        return x + rwkv.channel_mix(p["ffn"], h, _shift(h)), aux
    raise NotImplementedError(f"block kind {kind!r}: {NOT_PORTED_LM}")


def forward(params: dict, cfg: LMConfig, tokens: torch.Tensor,
            prefix_emb: Optional[torch.Tensor] = None):
    """Full-sequence forward: tokens [B, S] -> (logits [B, S, V_padded],
    aux), aux the f32 scalar MoE loss (0 here)."""
    _require_ported(cfg)
    _no_prefix(prefix_emb)
    x = _embed(params, cfg, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    blocks = params["dense"]["blocks"]
    for rep in range(cfg.n_repeats):
        block = _repeat(blocks, rep)
        for i, kind in enumerate(cfg.block_pattern):
            x, aux = _apply_position(block[f"pos_{i}"], kind, cfg, x, aux)
    x = layers.rmsnorm(params["dense"]["final_norm"], x, cfg.norm_eps)
    logits = x @ params["dense"]["head"].to(cfg.dtype)
    logits = _mask_pad_vocab(logits, cfg)
    return logits.to(_torch_dtype(cfg.logits_dtype)), aux


def _mask_pad_vocab(logits, cfg: LMConfig):
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.padded_vocab, device=logits.device) \
        >= cfg.vocab_size
    # a fill, not a copy of a host scalar: a CUDA graph may capture it
    return logits.masked_fill(pad, -1e30)


def loss_fn(params, cfg: LMConfig, tokens, prefix_emb=None):
    """Next-token cross-entropy (mean over predicted positions) + MoE aux.
    The forward only: training (``--task lm``) is not ported."""
    logits, aux = forward(params, cfg, tokens, prefix_emb)
    pred = logits[:, : tokens.shape[1] - 1]
    tgt = tokens[:, 1:]
    # f32 accumulation regardless of logits storage dtype
    logz = torch.logsumexp(pred.to(torch.float32), dim=-1)
    gold = torch.take_along_dim(pred, tgt[..., None].long(), dim=-1)[..., 0]
    ce = torch.mean(logz - gold.to(torch.float32))
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """Stacked decode state per pattern position: an ``RWKVState`` whose
    leaves are ``[n_repeats, ...]``. ``max_len`` sizes attention caches,
    which the ported kinds do not have."""
    _require_ported(cfg)
    device = resolve_device(device)
    cache = {}
    for i, kind in enumerate(cfg.block_pattern):
        one = rwkv.init_rwkv_state(batch, cfg.d_model, cfg.n_heads,
                                   device=device)
        cache[f"pos_{i}"] = tree_map(
            lambda t: t.expand((cfg.n_repeats,) + t.shape).contiguous(), one)
    return cache


def _decode_position(p, kind, cfg, x, state):
    if kind == "rwkv6":
        h = layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
        y, state = rwkv.rwkv6_decode(p["att"], h, state, n_heads=cfg.n_heads)
        x = x + y
        h = layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
        y, state = rwkv.channel_mix_decode(p["ffn"], h, state)
        return x + y, state
    raise NotImplementedError(f"block kind {kind!r}: {NOT_PORTED_LM}")


def decode_step(params: dict, cfg: LMConfig, token: torch.Tensor,
                cache: dict, cur_index, *, inplace: bool = False):
    """One serving step: the latest tokens [B] -> (next-token logits
    [B, V_padded] f32, updated cache). ``cur_index`` (tokens already in the
    cache) positions attention caches; the recurrent state needs none, so
    a captured step is right at any position. With ``inplace`` each
    layer's new state is written into ``cache`` itself (after that layer
    has read its old one), which is returned: what a CUDA graph over a
    static cache needs (``serve.decode.DecodeGraph``)."""
    _require_ported(cfg)
    x = _embed(params, cfg, token[:, None])
    blocks = params["dense"]["blocks"]
    per_repeat = []
    for rep in range(cfg.n_repeats):
        block, block_cache = _repeat(blocks, rep), _repeat(cache, rep)
        new_states = {}
        for i, kind in enumerate(cfg.block_pattern):
            x, new_states[f"pos_{i}"] = _decode_position(
                block[f"pos_{i}"], kind, cfg, x, block_cache[f"pos_{i}"])
            if inplace:
                tree_map(lambda old, new: old.copy_(new),
                         block_cache[f"pos_{i}"], new_states[f"pos_{i}"])
        per_repeat.append(new_states)
    x = layers.rmsnorm(params["dense"]["final_norm"], x, cfg.norm_eps)
    logits = (x[:, 0] @ params["dense"]["head"].to(cfg.dtype)).to(
        torch.float32)
    return (_mask_pad_vocab(logits, cfg),
            cache if inplace else _stack(per_repeat))


def prefill(params: dict, cfg: LMConfig, tokens: torch.Tensor,
            prefix_emb: Optional[torch.Tensor] = None):
    """Score-only prefill: forward the prompt, return last-position logits
    (the ``prefill_32k`` benchmark shape — forward cost dominates).
    For the serving handoff use ``prefill_with_cache``."""
    logits, _ = forward(params, cfg, tokens, prefix_emb)
    return logits[:, -1]


def _prefill_position(p, kind: str, cfg: LMConfig, x):
    """One layer over the prompt, populating its decode state."""
    if kind == "rwkv6":
        h = layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
        y, s_fin = rwkv.rwkv6_train(p["att"], h, n_heads=cfg.n_heads,
                                    backend=cfg.wkv_backend,
                                    return_state=True)
        x = x + y
        h2 = layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + rwkv.channel_mix(p["ffn"], h2, _shift(h2))
        state = rwkv.RWKVState(
            x_prev=h[:, -1].to(torch.float32),
            s=s_fin,
            x_prev_ffn=h2[:, -1].to(torch.float32),
        )
        return x, state
    raise NotImplementedError(f"block kind {kind!r}: {NOT_PORTED_LM}")


def prefill_with_cache(params: dict, cfg: LMConfig, tokens: torch.Tensor,
                       max_len: int,
                       prefix_emb: Optional[torch.Tensor] = None):
    """Serving prefill: forward the prompt AND populate every layer's decode
    state, so ``decode_step`` continues from ``cur_index = S``.

    Returns (last_logits [B, V_padded] f32, cache, cur_index)."""
    _require_ported(cfg)
    _no_prefix(prefix_emb)
    x = _embed(params, cfg, tokens)
    blocks = params["dense"]["blocks"]
    per_repeat = []
    for rep in range(cfg.n_repeats):
        block = _repeat(blocks, rep)
        states = {}
        for i, kind in enumerate(cfg.block_pattern):
            x, states[f"pos_{i}"] = _prefill_position(block[f"pos_{i}"],
                                                      kind, cfg, x)
        per_repeat.append(states)
    x = layers.rmsnorm(params["dense"]["final_norm"], x, cfg.norm_eps)
    logits = (x[:, -1] @ params["dense"]["head"].to(cfg.dtype)).to(
        torch.float32)
    return _mask_pad_vocab(logits, cfg), _stack(per_repeat), x.shape[1]


# ---------------------------------------------------------------------------
# accounting helpers
# ---------------------------------------------------------------------------


def param_counts(cfg: LMConfig) -> dict:
    """Total and active parameter counts, from params built on the ``meta``
    device (nothing is allocated)."""
    params = init(cfg, device="meta")
    total = sum(t.numel() for t in tree_leaves(params))
    return {"total": total, "active": total}
