"""Transformer building blocks, as in ``repro.models.layers``: RMSNorm,
RoPE, GQA/MQA attention (full / sliding-window; train, prefill and
single-token decode) with its KV caches, and the MLP / SwiGLU.

Conventions (the reference's):

* Params are plain dicts of tensors; init functions take a
  ``torch.Generator`` and a ``lead`` shape that prepends stacking dims
  (``[n_repeats]`` in ``lm.init``). Their values differ from JAX's for the
  same seed, so tests carry JAX params across.
* Activations run in the compute dtype, params stay f32 and are cast at
  use; norms, rope and softmax run in f32.
* Attention layouts: q ``[B, S, H, hd]``, kv ``[B, S, K, hd]`` with
  ``G = H // K`` query groups per kv head.
* Decode caches are fixed-capacity buffers; a sliding-window layer's is a
  ring of ``min(window, max_len)`` slots. The write cursor may be a 0-dim
  int64 tensor on the device (what a CUDA graph replays) or a Python int.

Attention is plain PyTorch (matmuls and a softmax) in the reference's op
order: the scores are computed in the compute dtype, cast to f32, scaled,
masked with an additive -1e30 and soft-maxed in f32, the probabilities
cast back. A fused library attention rounds differently, so none is used.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..sharding.act import (axis_size, constrain, current_mesh,
                            local_region)

NEG_INF = -1e30
F32 = torch.float32


# ---------------------------------------------------------------------------
# norms & positional encoding
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, *, lead: tuple = (), device="cuda") -> dict:
    """``lead`` prepends stacking dims (``[n_repeats]`` in ``lm.init``)."""
    return {"scale": torch.ones(lead + (d,), dtype=F32,
                                device=resolve_device(device))}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim, in f32. On a mesh (the dry-run) each
    rank normalises its own rows (``sharding.act.local_region``), so its
    backward keeps the rows' layout: DTensor's own choice splits the
    tokens over "model" there."""
    rows = ("batch",) + (None,) * (x.dim() - 1)
    return local_region(lambda x, scale: _rmsnorm(x, scale, eps),
                        (rows, (None,) * params["scale"].dim()),
                        (tuple(x.shape), rows))(x, params["scale"])


def _rmsnorm(x, scale, eps):
    dt = x.dtype
    xf = x.to(F32)
    y = xf * torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True)
                         + eps)
    return (y * scale).to(dt)


def rope_freqs(head_dim: int, theta: float = 1e4, *,
               device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=F32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # [hd/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, N, hd]; positions: [B, S] (absolute token positions).
    The last dim is rotated as two halves (not interleaved pairs), in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)              # [hd/2]
    angles = positions[..., None].to(F32) * freqs               # [B,S,hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _normal(gen, shape, scale, device):
    return torch.randn(shape, generator=gen, device=device).mul_(scale)


def init_attention(gen, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, n_heads_alloc: int | None = None, *,
                   lead: tuple = (), device="cuda") -> dict:
    """``n_heads_alloc`` > n_heads pads the query heads (e.g. 56 -> 64 so
    heads divide a 16-way model axis). Padded heads are masked to zero in
    the forward (``_grouped_attn``), so the model is the unpadded one."""
    device = resolve_device(device)
    h = n_heads_alloc or n_heads
    s = 1.0 / math.sqrt(d_model)
    return {
        "wq": _normal(gen, lead + (d_model, h, head_dim), s, device),
        "wk": _normal(gen, lead + (d_model, n_kv_heads, head_dim), s, device),
        "wv": _normal(gen, lead + (d_model, n_kv_heads, head_dim), s, device),
        "wo": _normal(gen, lead + (h, head_dim, d_model),
                      1.0 / math.sqrt(n_heads * head_dim), device),
    }


def _proj(x, w, dtype):
    """einsum("bsd,dhk->bshk", x, w) as one matmul over the flattened
    heads. On a mesh (the dry-run), where the heads do not divide
    "model", each rank projects its batch rows onto every head (the
    weight gathered whole): head_dim is never split."""
    h, k = w.shape[1:]
    if h % axis_size("model"):
        return local_region(
            lambda x, w: _heads(x, w, dtype), (("batch", None, None),
                                               (None, None, None)),
            (tuple(x.shape[:-1]) + (h, k), ("batch", None, None, None)),
        )(x, w)
    return _heads(x, w, dtype)


def _heads(x, w, dtype):
    d, h, k = w.shape
    return (x @ w.to(dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _out_proj(out, wo, dtype):
    """einsum("bshk,hkd->bsd", out, wo)."""
    h, k, d = wo.shape
    return out.flatten(-2) @ wo.to(dtype).reshape(h * k, d)


def _qkv(params, x, positions, theta, dtype):
    q = _proj(x, params["wq"], dtype)
    k = _proj(x, params["wk"], dtype)
    v = _proj(x, params["wv"], dtype)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    return q, k, v


def _causal_mask(s_q: int, s_k: int, window: Optional[int], *,
                 device=None) -> torch.Tensor:
    """[s_q, s_k] additive mask. Queries are the last s_q of s_k
    positions."""
    q_pos = torch.arange(s_q, device=device)[:, None] + (s_k - s_q)
    k_pos = torch.arange(s_k, device=device)[None, :]
    ok = k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    return _additive(ok)


def _additive(ok: torch.Tensor) -> torch.Tensor:
    """0 where ``ok``, -1e30 elsewhere, f32 (a fill: a graph captures it)."""
    return torch.zeros(ok.shape, dtype=F32, device=ok.device).masked_fill_(
        ~ok, NEG_INF)


def _grouped_attn(q, k, v, mask, n_valid: int | None = None):
    """q: [B,Sq,H,hd], k/v: [B,Sk,K,hd], mask: broadcastable to
    [B,K,G,Sq,Sk]. ``n_valid`` masks padded query heads to zero output."""
    b, sq, h, hd = q.shape
    sk, kheads = k.shape[1], k.shape[2]
    g = h // kheads
    # [B,K,G,Sq,hd] as [B,K,G*Sq,hd]: one matmul a kv head, G folded in
    qg = q.reshape(b, sq, kheads, g, hd).permute(0, 2, 3, 1, 4).reshape(
        b, kheads, g * sq, hd)
    kt = k.permute(0, 2, 3, 1)                                 # [B,K,hd,Sk]
    scores = (qg @ kt).to(F32).view(b, kheads, g, sq, sk)
    scores = scores.div_(math.sqrt(hd)).add_(mask)    # on a temporary
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = probs.view(b, kheads, g * sq, sk) @ v.permute(0, 2, 1, 3)
    out = out.view(b, kheads, g, sq, hd).permute(0, 3, 1, 2, 4).reshape(
        b, sq, h, hd)
    if n_valid is not None and n_valid < h:
        head_ok = (torch.arange(h, device=q.device) < n_valid)[
            None, None, :, None]
        out = out * head_ok.to(out.dtype)
    return out


def _attend(q, k, v, mask, n_valid: int | None = None):
    """``_grouped_attn``; on a mesh (the dry-run) each rank attends its
    own batch rows and kv heads (``sharding.act.local_region``), the
    heads split over "model" where the kv heads divide it, and the padded
    heads masked after."""
    if current_mesh() is None:
        return _grouped_attn(q, k, v, mask, n_valid)
    heads = "model" if k.shape[2] % axis_size("model") == 0 else None
    qa, ka = ("batch", None, heads, None), ("batch", None, heads, None)
    out = local_region(_grouped_attn, (qa, ka, ka, None),
                       (tuple(q.shape), qa))(q, k, v, mask)
    h = q.shape[2]
    if n_valid is not None and n_valid < h:
        head_ok = (torch.arange(h, device=q.device) < n_valid)[
            None, None, :, None]
        out = out * head_ok.to(out.dtype)
    return out


def attention_train(params, x, *, theta: float, window: Optional[int] = None,
                    n_valid_heads: Optional[int] = None):
    """Full training/prefill attention over [B, S, D] -> [B, S, D]."""
    y, _, _ = _attention_full(params, x, theta, window, n_valid_heads)
    return y


def _attention_full(params, x, theta, window, n_valid_heads):
    b, s, _ = x.shape
    dtype = x.dtype
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv(params, x, positions, theta, dtype)
    mask = _causal_mask(s, s, window, device=x.device)
    out = _attend(q, k, v, mask, n_valid_heads)
    return _out_proj(out, params["wo"], dtype), k, v


class KVCache(NamedTuple):
    """Fixed-capacity KV cache. ``capacity == window`` makes it a ring."""

    k: torch.Tensor        # [B, cap, K, hd]
    v: torch.Tensor        # [B, cap, K, hd]

    @property
    def capacity(self) -> int:
        return self.k.shape[-3]


def init_kv_cache(batch: int, capacity: int, n_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, *, device="cuda") -> KVCache:
    shape = (batch, capacity, n_kv_heads, head_dim)
    device = resolve_device(device)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def attention_decode(params, x: torch.Tensor, cache: KVCache, cur_index, *,
                     theta: float, window: Optional[int] = None,
                     n_valid_heads: Optional[int] = None,
                     inplace: bool = False):
    """One decode step: x [B, 1, D] at position ``cur_index`` (the tokens
    already cached: a 0-dim integer tensor on x's device, or an int).
    Returns ([B, 1, D], cache).

    With ``window`` the cache is a ring and attention covers the last
    ``capacity`` positions; otherwise a linear buffer. The new K/V row goes
    to slot ``cur_index % capacity``: into a copy of the cache (the
    reference's functional update), or, with ``inplace``, into ``cache``
    itself, which is returned. Nothing is read on the host, so a CUDA graph
    can capture the step with the cursor a tensor it advances."""
    b = x.shape[0]
    dtype = x.dtype
    cur = torch.as_tensor(cur_index, device=x.device).to(torch.int64)
    q, k_new, v_new = _qkv(params, x, cur.expand(b, 1), theta, dtype)

    cap = cache.capacity
    slot = (cur % cap).reshape(1)
    if inplace:
        k = cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
        v = cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))
    else:
        k = cache.k.index_copy(1, slot, k_new.to(cache.k.dtype))
        v = cache.v.index_copy(1, slot, v_new.to(cache.v.dtype))

    # slot i holds position i (linear), or the latest position p with
    # p % cap == i, p <= cur (ring, whose capacity is the window)
    idx = torch.arange(cap, device=x.device)
    valid = idx <= cur
    if window is not None:
        valid = valid | (cur >= cap)
    out = _attend(q, k.to(dtype), v.to(dtype), _additive(valid),
                  n_valid_heads)
    return _out_proj(out, params["wo"], dtype), KVCache(k=k, v=v)


def attention_prefill(params, x, cache: KVCache, *, theta: float,
                      window: Optional[int] = None,
                      n_valid_heads: Optional[int] = None):
    """Prefill: the full forward AND the cache filled (the first ``S``
    slots, or, when the capacity is below ``S``, the last ``capacity``
    tokens laid out so that slot i holds position p with p % cap == i).
    ``cache`` is not written. Returns ([B, S, D], cache)."""
    s = x.shape[1]
    y, k, v = _attention_full(params, x, theta, window, n_valid_heads)
    cap = cache.capacity
    if cap >= s:
        new_k, new_v = cache.k.clone(), cache.v.clone()
        new_k[:, :s] = k
        new_v[:, :s] = v
    else:
        shift = (s - cap) % cap
        new_k = torch.roll(k[:, s - cap:], shift, dims=1).to(cache.k.dtype)
        new_v = torch.roll(v[:, s - cap:], shift, dims=1).to(cache.v.dtype)
    return y, KVCache(k=new_k, v=new_v)


# ---------------------------------------------------------------------------
# feed-forward
# ---------------------------------------------------------------------------


def _hidden(h):
    return constrain(h, *(("batch",) + (None,) * (h.dim() - 2) + ("model",)))


def init_mlp(gen, d_model: int, d_ff: int, act: str = "swiglu", *,
             lead: tuple = (), device="cuda") -> dict:
    device = resolve_device(device)
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    p = {
        "w_in": _normal(gen, lead + (d_model, d_ff), s_in, device),
        "w_out": _normal(gen, lead + (d_ff, d_model), s_out, device),
    }
    if act == "swiglu":
        p["w_gate"] = _normal(gen, lead + (d_model, d_ff), s_in, device)
    return p


def mlp(params: dict, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    """The FFN; on a mesh (the dry-run) its hidden activation is split
    over "model" by its features (Megatron's column-parallel layout),
    which DTensor's op-by-op choice would otherwise split by tokens."""
    dtype = x.dtype
    h = _hidden(x @ params["w_in"].to(dtype))
    if act == "swiglu":
        g = _hidden(x @ params["w_gate"].to(dtype))
        h = F.silu(g) * h
    elif act == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h, approximate="tanh")
    elif act == "relu":
        h = F.relu(h)
    else:
        raise ValueError(f"unknown act {act!r}")
    return h @ params["w_out"].to(dtype)
