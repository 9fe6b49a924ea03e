"""RWKV-6 "Finch" mixer: linear attention with data-dependent per-channel
decay (arXiv:2404.05892), plus the RWKV channel-mix FFN.

A port of ``repro.models.rwkv``. Recurrence per head (key dim N == value
dim N):

    S_t = diag(w_t) . S_{t-1} + k_t v_t^T          (state  [N, N])
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)      (output [N])

with w_t = exp(-exp(wlog_t)) data-dependent via a low-rank projection, u a
learned per-channel bonus, and token-shift interpolation feeding r/k/v/w/g.

The sequence forward runs either the exact token recurrence (``"scan"``)
or the chunked scan (``"chunked"``), which goes through
``kernels.wkv6.wkv6`` at every length (a ragged one padded to a whole
chunk): the CUDA kernel on the card, its plain chunked version on the
CPU. Decode carries ``RWKVState`` between steps. The scan backend keeps
the reference's sharding hints (``sharding.act.constrain``, no-ops off a
mesh) on its state and its head-major streams.

Init functions take a ``torch.Generator`` and a ``lead`` shape that
prepends stacking dims (``[n_repeats]`` in ``lm.init``); their values
differ from JAX's for the same seed, so tests carry JAX params across.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..kernels.wkv6 import wkv6
from ..sharding.act import constrain, local_region
from .layers import _normal

F32 = torch.float32


def init_rwkv6(gen, d_model: int, n_heads: int, decay_rank: int = 64, *,
               lead: tuple = (), device="cuda") -> dict:
    device = resolve_device(device)
    n = d_model // n_heads
    s = 1.0 / math.sqrt(d_model)

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=F32, device=device)

    def normal(shape, scale):
        return _normal(gen, lead + shape, scale, device)

    return {
        "mix_r": full((d_model,), 0.5),
        "mix_k": full((d_model,), 0.5),
        "mix_v": full((d_model,), 0.5),
        "mix_w": full((d_model,), 0.5),
        "mix_g": full((d_model,), 0.5),
        "wr": normal((d_model, d_model), s),
        "wk": normal((d_model, d_model), s),
        "wv": normal((d_model, d_model), s),
        "wg": normal((d_model, d_model), s),
        "wo": normal((d_model, d_model), s),
        # data-dependent decay: wlog_t = w0 + (tanh(x A) B)
        "w0": full((d_model,), -0.6),  # exp(-exp(-0.6)) ~ 0.58
        "wA": normal((d_model, decay_rank), s),
        "wB": normal((decay_rank, d_model), 0.01),
        "u": normal((d_model,), 0.1),
        "ln_scale": full((n_heads, n), 1.0),
    }


class RWKVState(NamedTuple):
    x_prev: torch.Tensor      # [B, D] previous token into time-mix (token shift)
    s: torch.Tensor           # [B, H, N, N] wkv state (f32)
    x_prev_ffn: torch.Tensor  # [B, D] previous token into channel-mix


def init_rwkv_state(batch: int, d_model: int, n_heads: int, *,
                    device="cuda") -> RWKVState:
    device = resolve_device(device)
    n = d_model // n_heads
    return RWKVState(
        x_prev=torch.zeros((batch, d_model), dtype=F32, device=device),
        s=torch.zeros((batch, n_heads, n, n), dtype=F32, device=device),
        x_prev_ffn=torch.zeros((batch, d_model), dtype=F32, device=device),
    )


def _streams(params, x, x_prev, dtype):
    """Token-shift lerp + projections. x, x_prev: [..., D]."""
    def lerp(mix):
        return x + (x_prev - x) * mix.to(dtype)

    r = lerp(params["mix_r"]) @ params["wr"].to(dtype)
    k = lerp(params["mix_k"]) @ params["wk"].to(dtype)
    v = lerp(params["mix_v"]) @ params["wv"].to(dtype)
    g = lerp(params["mix_g"]) @ params["wg"].to(dtype)
    wlog = params["w0"] + torch.tanh(
        lerp(params["mix_w"]) @ params["wA"].to(dtype)
    ) @ params["wB"].to(dtype)
    w = torch.exp(-torch.exp(wlog.to(F32)))                  # decay in (0,1)
    return r, k, v, g, w


def _wkv_step(params, n_heads, r, k, v, w, s):
    """One recurrence step. r/k/v/w: [B, D]; s: [B, H, N, N] f32."""
    b, d = r.shape
    n = d // n_heads
    rh = r.reshape(b, n_heads, n).to(F32)
    kh = k.reshape(b, n_heads, n).to(F32)
    vh = v.reshape(b, n_heads, n).to(F32)
    wh = w.reshape(b, n_heads, n)
    u = params["u"].reshape(n_heads, n)

    kv = kh[..., :, None] * vh[..., None, :]                  # [B,H,N,N]
    y = torch.einsum("bhn,bhnm->bhm", rh, s + u[None, :, :, None] * kv)
    s_new = wh[..., :, None] * s + kv
    return y, s_new


def _step(params, n_heads, r, k, v, w, s):
    """``_wkv_step``; on a mesh (the dry-run) each rank steps its own
    batch rows and heads (``sharding.act.local_region``)."""
    n = r.shape[-1] // n_heads
    streams = ("batch", "model")
    state = ("batch", "model", None, None)
    return local_region(
        lambda r, k, v, w, s, u: _wkv_step({"u": u}, u.shape[0] // n,
                                           r, k, v, w, s),
        (streams,) * 4 + (state, ("model",)),
        [((r.shape[0], n_heads, n), ("batch", "model", None)),
         (tuple(s.shape), state)],
    )(r, k, v, w, s, params["u"])


def _head_norm(params, y, eps=1e-5):
    """Per-head RMSNorm of the wkv output. y: [..., H, N] f32."""
    y = y * torch.rsqrt(torch.mean(torch.square(y), dim=-1, keepdim=True)
                        + eps)
    return y * params["ln_scale"][None]


def _wkv_chunked(params, n_heads, r, k, v, w, *, chunk: int = 16):
    """Chunked WKV over the full sequence through ``kernels.wkv6``, in f32.
    r/k/v/w: [B, S, D] -> (y [B, S, H, N], final state [B, H, N, N]).

    A length that is no multiple of ``chunk`` is padded at the end, up to
    a whole chunk, with r = k = v = 0 and w = 1: a padded step adds nothing
    to y or to the state (k = 0) and decays nothing (w = 1, log w = 0), so
    the real steps' y and the final state are those of the unpadded
    sequence, and the clip sees the same exponents. (The JAX twin instead
    falls back to the token scan; both equal the recurrence.)

    Differentiable: gradients flow back through the head-major copies and
    the pad (``F.pad``'s backward drops the padded steps) from the wkv6
    Function, whose backward is the backward kernel on the card and
    autograd through the plain chunked version on the CPU."""
    b, seq, d = r.shape
    n = d // n_heads
    pad = -seq % chunk
    full = seq + pad

    def heads(t, fill):   # [B, S, D] -> [B*H, S + pad, N], batch-major
        t = t.to(F32)
        if pad:
            t = F.pad(t, (0, 0, 0, pad), value=fill)
        return (t.reshape(b, full, n_heads, n).transpose(1, 2)
                .contiguous().reshape(b * n_heads, full, n))

    u = (params["u"].to(F32).reshape(1, n_heads, n).expand(b, n_heads, n)
         .contiguous().reshape(b * n_heads, n))
    y, s_fin = wkv6(heads(r, 0.0), heads(k, 0.0), heads(v, 0.0),
                    heads(w, 1.0), u, chunk=chunk)
    y = y.reshape(b, n_heads, full, n)[:, :, :seq].transpose(1, 2)
    return y, s_fin.reshape(b, n_heads, n, n)                  # [B,S,H,N]


def _chunked(params, n_heads, r, k, v, w):
    """``_wkv_chunked``; on a mesh (the dry-run) each rank runs the wkv6
    wrapper on its own batch rows and heads (``sharding.act.
    local_region``)."""
    b, seq, d = r.shape
    n = d // n_heads
    streams = ("batch", None, "model")
    return local_region(
        lambda r, k, v, w, u: _wkv_chunked({"u": u}, u.shape[0] // n,
                                           r, k, v, w),
        (streams,) * 4 + (("model",),),
        [((b, seq, n_heads, n), ("batch", None, "model", None)),
         ((b, n_heads, n, n), ("batch", "model", None, None))],
    )(r, k, v, w, params["u"])


def rwkv6_train(params, x, *, n_heads: int, backend: str = "scan",
                return_state: bool = False):
    """Sequence forward. x: [B, S, D] -> [B, S, D] (or (out, s_final) with
    ``return_state`` — the prefill -> decode handoff).

    backend: "scan" (token-recurrent, exact) or "chunked" (the wkv6
    kernel, any length; its final state is the recurrence's, carried
    unclipped). The reference's handoff always runs the scan; here the
    chunked backend hands over the kernel's state."""
    b, seq, d = x.shape
    dtype = x.dtype
    x_shift = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    r, k, v, g, w = _streams(params, x, x_shift, dtype)

    if backend == "chunked":
        y4, s_fin = _chunked(params, n_heads, r, k, v, w)
    else:
        n = d // n_heads
        s = constrain(torch.zeros((b, n_heads, n, n), dtype=F32,
                                  device=x.device),
                      "batch", "model", None, None)

        def heads4(t):
            # pin head sharding on the scan's inputs, so that a mesh keeps
            # the recurrence head-parallel
            return constrain(t.reshape(b, seq, n_heads, n), "batch", None,
                             "model", None).reshape(b, seq, d)

        r, k, v, w = heads4(r), heads4(k), heads4(v), heads4(w)
        ys = []
        for t in range(seq):
            y, s = _step(params, n_heads, r[:, t], k[:, t], v[:, t],
                         w[:, t], s)
            ys.append(y)
        s_fin = s
        y4 = torch.stack(ys, dim=1)                           # [B, S, H, N]
    y = _head_norm(params, y4)
    y = y.reshape(b, seq, d).to(dtype)
    out = (y * F.silu(g)) @ params["wo"].to(dtype)
    if return_state:
        return out, s_fin
    return out


def rwkv6_decode(params, x, state: RWKVState, *, n_heads: int):
    """One token. x: [B, 1, D] -> ([B, 1, D], new_state)."""
    b, _, d = x.shape
    dtype = x.dtype
    xt = x[:, 0]
    r, k, v, g, w = _streams(params, xt, state.x_prev.to(dtype), dtype)
    y, s_new = _step(params, n_heads, r, k, v, w, state.s)
    y = _head_norm(params, y).reshape(b, d).to(dtype)
    out = (y * F.silu(g)) @ params["wo"].to(dtype)
    new_state = state._replace(x_prev=xt.to(F32), s=s_new)
    return out[:, None], new_state


def channel_mix_decode(params, h, state: RWKVState):
    """One-token channel mix; h: [B, 1, D]. Returns ([B,1,D], new_state)."""
    h_prev = state.x_prev_ffn.to(h.dtype)[:, None]
    out = channel_mix(params, h, h_prev)
    return out, state._replace(x_prev_ffn=h[:, 0].to(F32))


# --------------------------------------------------------------------------
# channel mix (RWKV FFN)
# --------------------------------------------------------------------------


def init_channel_mix(gen, d_model: int, d_ff: int, *, lead: tuple = (),
                     device="cuda") -> dict:
    device = resolve_device(device)
    s = 1.0 / math.sqrt(d_model)
    return {
        "mix_k": torch.full(lead + (d_model,), 0.5, dtype=F32, device=device),
        "mix_r": torch.full(lead + (d_model,), 0.5, dtype=F32, device=device),
        "wk": _normal(gen, lead + (d_model, d_ff), s, device),
        "wv": _normal(gen, lead + (d_ff, d_model), 1.0 / math.sqrt(d_ff),
                      device),
        "wr": _normal(gen, lead + (d_model, d_model), s, device),
    }


def channel_mix(params, x, x_prev):
    """x, x_prev: [B, S, D] (x_prev is x shifted right by one token)."""
    dtype = x.dtype

    def lerp(mix):
        return x + (x_prev - x) * mix.to(dtype)

    k = torch.square(torch.relu(lerp(params["mix_k"])
                                @ params["wk"].to(dtype)))
    r = torch.sigmoid(lerp(params["mix_r"]) @ params["wr"].to(dtype))
    return r * (k @ params["wv"].to(dtype))
