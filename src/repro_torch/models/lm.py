"""Decoder LM assembled from a config, as in ``repro.models.lm``: the
``attn``, ``local``, ``rwkv6`` and ``mamba2`` block kinds, MoE FFNs,
zamba2's weight-shared attention block, and the audio / vision
frontends' prefix embeddings.

* **Stacked superblocks.** Layers are grouped into a repeating
  ``block_pattern``; every leaf of ``params["dense"]["blocks"]["pos_i"]``
  is stacked ``[n_repeats, ...]`` exactly as the reference's ``jax.vmap``
  stacks it, so the ``/``-keyed npz of ``train/checkpoint.py`` carries LM
  params across unchanged. The reference's ``jax.lax.scan`` over
  superblocks is a Python loop indexing the stacked leaves.
* **Two-group params.** ``{"embed": {"tokens": [V, D]}, "dense": ...}``.
* **Heterogeneous mixers.** Pattern entries pick the mixer per position.
  zamba2's shared attention + MLP block (``dense["shared"]``, not
  stacked) runs after every superblock; its weights are shared, its KV
  ring is not (``cache["shared"]``, one ring a superblock).
* **Decode states.** KV ring buffers for ``local``, linear KV buffers for
  ``attn`` (``layers.KVCache``), the O(1) recurrent ``RWKVState`` for
  ``rwkv6`` and ``MambaState`` for ``mamba2``; stacked per superblock
  like the params.
* **Frontends** (audio frames / vision patches) are precomputed
  embeddings ``[B, P, D]`` concatenated ahead of the token embeddings, as
  in the reference.
* **Cast points** are the reference's: the embedding is cast to the
  compute dtype, the mixers run in it with weights cast at use (the decay
  and the wkv scan in f32), norms accumulate in f32, logits are cast to
  ``logits_dtype``.
* **Training** (``loss_fn`` under autograd, ``train.loop.
  make_lm_train_step``): the token gather is the port's
  ``kernels.embedding.gather_fields``, so the table's gradient comes from
  its deterministic embedding backward; the wkv6 scan and the Mamba-2
  scan are differentiable.
* **Activation checkpointing** (``cfg.remat``): each superblock (the
  pattern's layers and zamba2's shared block) runs under
  ``torch.utils.checkpoint.checkpoint`` (non-reentrant), the
  counterpart of the reference's ``jax.checkpoint`` of its scan body.
  ``remat_policy="full"`` keeps only the superblock's input and
  recomputes the rest in the backward; ``"dots"`` (``_dots_policy``,
  the counterpart of ``dots_with_no_batch_dims_saveable``) also keeps
  the outputs of ``aten.mm`` / ``aten.addmm``. The gradients are the
  same bits as without remat. A kernel that no dispatch mode sees (the
  wkv6 forward kernel under autograd) is run again in the recompute,
  keeping its chunk states for the backward kernel, which runs once;
  the forward's launch counter counts it again.
* **Sharding hints.** ``sharding.act.constrain`` at the reference's
  places (the embedding, the logits) and on the residual stream after
  each layer; no-ops without a mesh (the dry-run's).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
from torch.utils import checkpoint as ckpt

from ..core.device import resolve_device
from ..core.tree import tree_leaves, tree_map
from ..kernels.embedding import gather_fields
from ..sharding.act import (constrain, current_mesh, local_region,
                            placements)
from . import layers, mamba, moe as moe_lib, rwkv
from .moe import MoEConfig


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
    moe: Optional[MoEConfig] = None
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


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def has_kv_cache(cfg: LMConfig) -> bool:
    """Whether decode state grows with ``max_len`` (an attention kind, or
    zamba2's shared block, whose rings hold ``min(window, max_len)``)."""
    return cfg.shared_attn or bool({"attn", "local"} & set(cfg.block_pattern))


def _init_position(gen, kind: str, cfg: LMConfig, device) -> dict:
    """Params of one layer position, stacked ``[n_repeats, ...]``."""
    d, lead = cfg.d_model, (cfg.n_repeats,)
    if kind in ("attn", "local"):
        return {
            "norm1": layers.init_rmsnorm(d, lead=lead, device=device),
            "attn": layers.init_attention(
                gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                cfg.n_heads_alloc, lead=lead, device=device),
            "norm2": layers.init_rmsnorm(d, lead=lead, device=device),
            "ffn": (moe_lib.init_moe(gen, d, cfg.d_ff, cfg.moe, cfg.act,
                                     lead=lead, device=device)
                    if cfg.moe is not None else
                    layers.init_mlp(gen, d, cfg.d_ff, cfg.act, lead=lead,
                                    device=device)),
        }
    if kind == "rwkv6":
        return {
            "norm1": layers.init_rmsnorm(d, lead=lead, device=device),
            "att": rwkv.init_rwkv6(gen, d, cfg.n_heads, lead=lead,
                                   device=device),
            "norm2": layers.init_rmsnorm(d, lead=lead, device=device),
            "ffn": rwkv.init_channel_mix(gen, d, cfg.d_ff, lead=lead,
                                         device=device),
        }
    if kind == "mamba2":
        return {
            "norm1": layers.init_rmsnorm(d, lead=lead, device=device),
            "mixer": mamba.init_mamba2(gen, d, d_state=cfg.ssm_state,
                                       head_dim=cfg.mamba_head_dim,
                                       lead=lead, device=device),
        }
    raise ValueError(kind)


def init(cfg: LMConfig, *, generator: torch.Generator | None = None,
         seed: int = 0, device="cuda") -> dict:
    """Random params for ``cfg`` on ``device`` (f32), drawn from
    ``generator`` (a fresh one seeded with ``seed`` when None). On the
    card the values are drawn there; ``device="meta"`` allocates
    nothing."""
    cfg.validate()
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(
            device="cpu" if device.type == "meta" else device
        ).manual_seed(seed)
    embed = {"tokens": layers._normal(generator,
                                      (cfg.padded_vocab, cfg.d_model),
                                      cfg.emb_sigma, device)}
    dense: dict = {"blocks": {
        f"pos_{i}": _init_position(generator, kind, cfg, device)
        for i, kind in enumerate(cfg.block_pattern)}}
    if cfg.shared_attn:
        d = cfg.d_model
        dense["shared"] = {
            "norm1": layers.init_rmsnorm(d, device=device),
            "attn": layers.init_attention(generator, d, cfg.n_heads,
                                          cfg.n_kv_heads, cfg.hd,
                                          cfg.n_heads_alloc, device=device),
            "norm2": layers.init_rmsnorm(d, device=device),
            "ffn": layers.init_mlp(generator, d, cfg.d_ff, cfg.act,
                                   device=device),
        }
    dense["final_norm"] = layers.init_rmsnorm(cfg.d_model, device=device)
    dense["head"] = layers._normal(generator,
                                   (cfg.d_model, cfg.padded_vocab),
                                   1.0 / math.sqrt(cfg.d_model), device)
    return {"embed": embed, "dense": dense}


def _repeat(tree, i: int):
    """Superblock ``i`` of a tree stacked ``[n_repeats, ...]``."""
    return tree_map(lambda t: t[i], tree)


def _stack(trees: list):
    return tree_map(lambda *ts: torch.stack(ts), *trees)


def _embed(params, cfg: LMConfig, tokens, prefix_emb=None):
    """The token rows (one field of ``gather_fields``: the same values as
    an index, and under autograd the port's embedding backward) in the
    compute dtype, after the prefix."""
    rows, = gather_fields([[params["embed"]["tokens"]]],
                          tokens.reshape(-1, 1))
    x = rows.reshape(*tokens.shape, -1).to(cfg.dtype)
    if prefix_emb is not None:
        x = torch.cat([prefix_emb.to(cfg.dtype), x], dim=1)
    return x


def _shift(h):
    """h shifted right by one token (zeros first)."""
    return torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)


# ---------------------------------------------------------------------------
# forward (training / scoring)
# ---------------------------------------------------------------------------


def _window(kind: str, cfg: LMConfig):
    return cfg.window if kind == "local" else None


def _ffn(p, cfg: LMConfig, h):
    """An attention position's FFN: (out, the MoE's aux loss or None)."""
    if cfg.moe is not None:
        return moe_lib.moe_ffn(p["ffn"], h, cfg.moe, cfg.act)
    return layers.mlp(p["ffn"], h, cfg.act), None


def _mamba(p, cfg: LMConfig, x, **kw):
    return mamba.mamba2_train(
        p["mixer"], layers.rmsnorm(p["norm1"], x, cfg.norm_eps),
        d_state=cfg.ssm_state, head_dim=cfg.mamba_head_dim, **kw)


def _apply_position(p, kind: str, cfg: LMConfig, x, aux):
    """One layer forward over a full sequence."""
    if kind in ("attn", "local"):
        x = x + layers.attention_train(
            p["attn"], layers.rmsnorm(p["norm1"], x, cfg.norm_eps),
            theta=cfg.rope_theta, window=_window(kind, cfg),
            n_valid_heads=cfg.n_heads,
        )
        y, a = _ffn(p, cfg, layers.rmsnorm(p["norm2"], x, cfg.norm_eps))
        return x + y, aux if a is None else aux + a
    if kind == "rwkv6":
        x = x + rwkv.rwkv6_train(
            p["att"], layers.rmsnorm(p["norm1"], x, cfg.norm_eps),
            n_heads=cfg.n_heads, backend=cfg.wkv_backend,
        )
        h = layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
        return x + rwkv.channel_mix(p["ffn"], h, _shift(h)), aux
    if kind == "mamba2":
        return x + _mamba(p, cfg, x), aux
    raise ValueError(kind)


def _shared_mlp(p, cfg: LMConfig, x):
    """The shared block's second half: x + its MLP."""
    return x + layers.mlp(p["ffn"], layers.rmsnorm(p["norm2"], x,
                                                   cfg.norm_eps), cfg.act)


def _apply_shared(p, cfg: LMConfig, x):
    """zamba2's shared attention (window ``cfg.window``) + MLP block."""
    x = x + layers.attention_train(
        p["attn"], layers.rmsnorm(p["norm1"], x, cfg.norm_eps),
        theta=cfg.rope_theta, window=cfg.window, n_valid_heads=cfg.n_heads,
    )
    return _shared_mlp(p, cfg, x)


# the products with no batch dimension, which ``remat_policy="dots"``
# keeps: a 2-D (or folded 3-D) activation times a 2-D weight
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the outputs of ``aten.mm`` and
    ``aten.addmm``, recompute everything else. Of the port's products,
    ``x @ w`` with ``x`` [B, S, D] and ``w`` [D, F] reaches the policy as
    ``aten.mm`` on a [B*S, D] view (the projections, the MLPs, the head,
    the routers, the rwkv and Mamba-2 in/out projections: kept);
    ``torch.einsum`` and a matmul of two batched operands reach it as
    ``aten.bmm`` (attention's scores and their weighted sum, the MoE
    experts' einsums, the rwkv scan's ``bhn,bhnm->bhm``, the plain
    chunked wkv6's products: recomputed), as in the reference, whose
    policy saves no ``dot_general`` with a batch dimension."""
    del ctx, args, kwargs
    if op in _SAVED_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _superblock(block, shared, cfg: LMConfig, x, aux):
    """One repeat of the pattern (and zamba2's shared block after it). On
    a mesh the residual stream is laid out over the batch after every
    layer (``_residual``)."""
    for i, kind in enumerate(cfg.block_pattern):
        x, aux = _apply_position(block[f"pos_{i}"], kind, cfg, x, aux)
        x = _residual(x)
    if shared is not None:
        x = _residual(_apply_shared(shared, cfg, x))
    return x, aux


def _residual(x):
    """The residual stream over the batch, replicated over "model" (on a
    mesh; else ``x`` itself): the Megatron layout, an all-reduce after a
    row-parallel product. The reference leaves this to XLA's propagation;
    DTensor's, op by op, would carry a partial sum from layer to layer
    and split the tokens over "model" in the backward."""
    return constrain(x, "batch", None, None)


def _remat_superblock(block, shared, cfg: LMConfig, x, aux):
    """``_superblock`` under activation checkpointing (``cfg.remat``)."""
    if cfg.remat_policy == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    elif cfg.remat_policy == "full":
        context_fn = ckpt.noop_context_fn
    else:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return ckpt.checkpoint(_superblock, block, shared, cfg, x, aux,
                           use_reentrant=False, context_fn=context_fn)


def forward(params: dict, cfg: LMConfig, tokens: torch.Tensor,
            prefix_emb: Optional[torch.Tensor] = None):
    """Full-sequence forward: tokens [B, S] (after the frontend's
    ``prefix_emb`` [B, P, D], if any) -> (logits [B, P + S, V_padded],
    aux), aux the f32 scalar MoE loss summed over the layers (0 without
    MoE). With ``cfg.remat`` each superblock is checkpointed
    (``_remat_superblock``)."""
    cfg.validate()
    x = constrain(_embed(params, cfg, tokens, prefix_emb), "batch", None,
                  None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    blocks = params["dense"]["blocks"]
    shared = params["dense"].get("shared")
    run = _remat_superblock if cfg.remat else _superblock
    for rep in range(cfg.n_repeats):
        x, aux = run(_repeat(blocks, rep), shared, cfg, x, aux)
    x = layers.rmsnorm(params["dense"]["final_norm"], x, cfg.norm_eps)
    logits = x @ params["dense"]["head"].to(cfg.dtype)
    logits = constrain(logits, "batch", None, "model")
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
    """Next-token cross-entropy (mean over predicted positions) + MoE aux,
    differentiable in every param leaf (``train.loop.make_lm_train_step``
    takes its gradient)."""
    logits, aux = forward(params, cfg, tokens, prefix_emb)
    # predictions come from positions [P .. P+S-2] for targets tokens[:, 1:]
    p = 0 if prefix_emb is None else prefix_emb.shape[1]
    pred = logits[:, p: p + tokens.shape[1] - 1]
    tgt = tokens[:, 1:]
    if current_mesh() is not None:
        return _mesh_loss(pred, tgt, aux)
    # f32 accumulation regardless of logits storage dtype
    logz = torch.logsumexp(pred.to(torch.float32), dim=-1)
    gold = torch.take_along_dim(pred, tgt[..., None].long(), dim=-1)[..., 0]
    ce = torch.mean(logz - gold.to(torch.float32))
    return ce + aux, {"ce": ce, "aux": aux}


def _mesh_loss(pred, tgt, aux):
    """``loss_fn``'s cross-entropy on a mesh (the dry-run), vocab-parallel
    as an SPMD partitioner lays it out: with the logits' vocab split over
    "model" each rank takes its block's max, sum of exponentials and gold
    logit, and three all-reduces over "model" of ``[B, S]`` finish them,
    where DTensor would gather the ``[B, S, V]`` logits."""
    from torch.distributed import _functional_collectives as funcol

    mesh = current_mesh()
    names = list(mesh.mesh_dim_names)
    lay = placements(pred.shape, ("batch", None, "model"), mesh)
    split = "model" in names and lay[names.index("model")].is_shard()

    def local(pred, tgt):
        v = pred.shape[-1]
        group = (mesh, names.index("model")) if split else None
        # the shift's gradient cancels: it carries none
        m = pred.detach().to(torch.float32).amax(dim=-1)
        if split:
            m = funcol.all_reduce(m, "max", group)
        z = torch.exp(pred.to(torch.float32) - m[..., None]).sum(dim=-1)
        off = mesh.get_local_rank("model") * v if split else 0
        idx = tgt.long() - off
        ok = (idx >= 0) & (idx < v)
        gold = torch.take_along_dim(pred, idx.clamp(0, v - 1)[..., None],
                                    dim=-1)[..., 0].to(torch.float32)
        gold = gold * ok.to(torch.float32)
        if split:
            z = funcol.all_reduce(z, "sum", group)
            gold = funcol.all_reduce(gold, "sum", group)
        return m + torch.log(z) - gold

    per_token = local_region(local, (("batch", None, "model"),
                                     ("batch", None)),
                             (tuple(tgt.shape), ("batch", None)))(pred, tgt)
    ce = torch.mean(per_token)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------


def _position_cache(kind: str, cfg: LMConfig, batch: int, max_len: int,
                    device):
    if kind == "attn":
        return layers.init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.hd,
                                    cfg.dtype, device=device)
    if kind == "local":
        return layers.init_kv_cache(batch, min(cfg.window, max_len),
                                    cfg.n_kv_heads, cfg.hd, cfg.dtype,
                                    device=device)
    if kind == "rwkv6":
        return rwkv.init_rwkv_state(batch, cfg.d_model, cfg.n_heads,
                                    device=device)
    if kind == "mamba2":
        return mamba.init_mamba_state(batch, cfg.d_model,
                                      d_state=cfg.ssm_state,
                                      head_dim=cfg.mamba_head_dim,
                                      device=device)
    raise ValueError(kind)


def _fresh_cache(cfg: LMConfig, batch: int, max_len: int, device) -> dict:
    """One superblock's empty decode state: each pattern position's, and
    the shared block's ring of ``min(window or max_len, max_len)``
    slots."""
    fresh = {f"pos_{i}": _position_cache(kind, cfg, batch, max_len, device)
             for i, kind in enumerate(cfg.block_pattern)}
    if cfg.shared_attn:
        fresh["shared"] = layers.init_kv_cache(
            batch, min(cfg.window or max_len, max_len), cfg.n_kv_heads,
            cfg.hd, cfg.dtype, device=device)
    return fresh


def init_cache(cfg: LMConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """Stacked decode state, leaves ``[n_repeats, ...]``: per pattern
    position a ``KVCache`` of ``max_len`` slots (``attn``) or of
    ``min(window, max_len)`` (``local``), an ``RWKVState`` or a
    ``MambaState``; with ``shared_attn`` the shared block's rings under
    ``"shared"``."""
    cfg.validate()
    fresh = _fresh_cache(cfg, batch, max_len, resolve_device(device))
    return tree_map(
        lambda t: t.expand((cfg.n_repeats,) + t.shape).contiguous(), fresh)


def _copy_into(old, new, inplace):
    """A recurrent state's update: with ``inplace`` copied over ``old``
    (after the layer has read it), else ``new`` as it is."""
    return tree_map(lambda o, n: o.copy_(n), old, new) if inplace else new


def _decode_position(p, kind, cfg, x, state, cur_index, inplace):
    """One layer of a decode step. With ``inplace`` the new state is in
    ``state``'s tensors on return (a KV row written in place, or the
    recurrent state copied over after the layer has read it)."""
    if kind in ("attn", "local"):
        h = layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
        y, state = layers.attention_decode(
            p["attn"], h, state, cur_index, theta=cfg.rope_theta,
            window=_window(kind, cfg), n_valid_heads=cfg.n_heads,
            inplace=inplace,
        )
        x = x + y
        y, _ = _ffn(p, cfg, layers.rmsnorm(p["norm2"], x, cfg.norm_eps))
        return x + y, state
    if kind == "rwkv6":
        old = state
        h = layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
        y, state = rwkv.rwkv6_decode(p["att"], h, state, n_heads=cfg.n_heads)
        x = x + y
        h = layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
        y, state = rwkv.channel_mix_decode(p["ffn"], h, state)
        return x + y, _copy_into(old, state, inplace)
    if kind == "mamba2":
        h = layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
        y, new = mamba.mamba2_decode(p["mixer"], h, state,
                                     d_state=cfg.ssm_state,
                                     head_dim=cfg.mamba_head_dim)
        return x + y, _copy_into(state, new, inplace)
    raise ValueError(kind)


def decode_step(params: dict, cfg: LMConfig, token: torch.Tensor,
                cache: dict, cur_index, *, inplace: bool = False):
    """One serving step: the latest tokens [B] -> (next-token logits
    [B, V_padded] f32, updated cache). ``cur_index`` (tokens already in the
    cache: a 0-dim integer tensor on the device, or an int) is the new
    token's position, its rope angle and its KV slot; the recurrent states
    need none. With ``inplace`` each layer's new state is written into
    ``cache`` itself (after that layer has read its old one), which is
    returned: what a CUDA graph over a static cache and a device cursor
    needs (``serve.decode.DecodeGraph``). Without it, every layer's cache
    is copied, as the reference's functional update is."""
    cfg.validate()
    x = _embed(params, cfg, token[:, None])
    if not isinstance(cur_index, torch.Tensor):
        cur_index = torch.tensor(cur_index, dtype=torch.int64,
                                 device=x.device)
    blocks = params["dense"]["blocks"]
    shared = params["dense"].get("shared")
    per_repeat = []
    for rep in range(cfg.n_repeats):
        block, block_cache = _repeat(blocks, rep), _repeat(cache, rep)
        new_states = {}
        for i, kind in enumerate(cfg.block_pattern):
            x, new_states[f"pos_{i}"] = _decode_position(
                block[f"pos_{i}"], kind, cfg, x, block_cache[f"pos_{i}"],
                cur_index, inplace)
        if shared is not None:
            h = layers.rmsnorm(shared["norm1"], x, cfg.norm_eps)
            y, new_states["shared"] = layers.attention_decode(
                shared["attn"], h, block_cache["shared"], cur_index,
                theta=cfg.rope_theta, window=cfg.window,
                n_valid_heads=cfg.n_heads, inplace=inplace)
            x = _shared_mlp(shared, cfg, x + y)
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


def _prefill_position(p, kind: str, cfg: LMConfig, x, fresh_state):
    """One layer over the prompt, populating its decode state."""
    if kind in ("attn", "local"):
        h = layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
        y, state = layers.attention_prefill(
            p["attn"], h, fresh_state, theta=cfg.rope_theta,
            window=_window(kind, cfg), n_valid_heads=cfg.n_heads)
        x = x + y
        y, _ = _ffn(p, cfg, layers.rmsnorm(p["norm2"], x, cfg.norm_eps))
        return x + y, state
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
    if kind == "mamba2":
        y, state = _mamba(p, cfg, x, return_state=True)
        return x + y, state
    raise ValueError(kind)


def prefill_with_cache(params: dict, cfg: LMConfig, tokens: torch.Tensor,
                       max_len: int,
                       prefix_emb: Optional[torch.Tensor] = None):
    """Serving prefill: forward the prompt (after ``prefix_emb``, if any)
    AND populate every layer's decode state (linear / ring KV buffers,
    recurrent states, the shared block's rings), so ``decode_step``
    continues from ``cur_index = P + S``.

    Returns (last_logits [B, V_padded] f32, cache, cur_index)."""
    cfg.validate()
    x = constrain(_embed(params, cfg, tokens, prefix_emb), "batch", None,
                  None)
    fresh = _fresh_cache(cfg, x.shape[0], max_len, x.device)
    blocks = params["dense"]["blocks"]
    shared = params["dense"].get("shared")
    per_repeat = []
    for rep in range(cfg.n_repeats):
        block = _repeat(blocks, rep)
        states = {}
        for i, kind in enumerate(cfg.block_pattern):
            x, states[f"pos_{i}"] = _prefill_position(
                block[f"pos_{i}"], kind, cfg, x, fresh[f"pos_{i}"])
        if shared is not None:
            h = layers.rmsnorm(shared["norm1"], x, cfg.norm_eps)
            y, states["shared"] = layers.attention_prefill(
                shared["attn"], h, fresh["shared"], theta=cfg.rope_theta,
                window=cfg.window, n_valid_heads=cfg.n_heads)
            x = _shared_mlp(shared, cfg, x + y)
        per_repeat.append(states)
    x = layers.rmsnorm(params["dense"]["final_norm"], x, cfg.norm_eps)
    logits = (x[:, -1] @ params["dense"]["head"].to(cfg.dtype)).to(
        torch.float32)
    return _mask_pad_vocab(logits, cfg), _stack(per_repeat), x.shape[1]


# ---------------------------------------------------------------------------
# accounting helpers
# ---------------------------------------------------------------------------


def param_counts(cfg: LMConfig) -> dict:
    """Total and active (MoE top-k) parameter counts, from params built on
    the ``meta`` device (nothing is allocated)."""
    params = init(cfg, device="meta")
    total = sum(t.numel() for t in tree_leaves(params))
    active = total
    if cfg.moe is not None:
        expert_params = sum(
            pos["ffn"][name].numel()
            for pos in params["dense"]["blocks"].values()
            if "ffn" in pos and "router" in pos["ffn"]
            for name in ("w_in", "w_out", "w_gate") if name in pos["ffn"])
        frac = cfg.moe.top_k / cfg.moe.n_experts
        active = total - expert_params + int(expert_params * frac)
    return {"total": total, "active": active}
