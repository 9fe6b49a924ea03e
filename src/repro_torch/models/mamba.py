"""Mamba-2 (SSD) mixer — selective state-space with scalar per-head decay
(Dao & Gu 2024), as used by zamba2's backbone (arXiv:2411.15242); a port
of ``repro.models.mamba``.

Per head h (head dim P, state dim N):

    dt_t  = softplus(dt_raw_t + dt_bias_h)            (selective step size)
    a_t   = exp(-dt_t * A_h)                          (scalar decay, A_h > 0)
    S_t   = a_t * S_{t-1} + dt_t * (x_t ⊗ B_t)        (state [P, N])
    y_t   = S_t C_t + D_h * x_t

x/B/C pass through a short causal depthwise conv (kernel 4). Output is gated
by silu(z) and RMSNorm'd before the out projection (Mamba-2 block layout).
The in- and out-projections run in the compute dtype, everything between
them in f32, as in the reference.

The sequence forward runs the recurrence token by token, as the
reference's ``jax.lax.scan`` does: ``a_t`` and ``dt_t (x_t ⊗ B_t)`` are
formed for ``SCAN_CHUNK`` tokens at a time, each token's state is then a
multiply and an add into a buffer of the chunk's states, and ``y`` is one
batched product with C a chunk. Every element goes through the
reference's operations in its order. Under autograd (training) a token's
state is a new tensor, ``a * s + dbx``, stacked a chunk, since autograd
refuses the buffer's ``out=`` writes; serving keeps the buffer (no
allocation a token in a captured graph). The two give the same bits.
Decode carries ``MambaState`` — O(1) in sequence length.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from .layers import _normal

F32 = torch.float32
CONV_K = 4
SCAN_CHUNK = 64    # tokens whose decay and input term are formed at once


def init_mamba2(gen, d_model: int, *, d_state: int = 64, head_dim: int = 64,
                expand: int = 2, lead: tuple = (), device="cuda") -> dict:
    """``lead`` prepends stacking dims (``[n_repeats]`` in ``lm.init``)."""
    device = resolve_device(device)
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * d_state

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=F32, device=device)

    a_log = torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=F32,
                                     device=device))
    return {
        # in_proj -> [z, x, B, C, dt]
        "w_in": _normal(gen, lead + (d_model, 2 * d_inner + 2 * d_state
                                     + n_heads),
                        1.0 / math.sqrt(d_model), device),
        "conv_w": _normal(gen, lead + (CONV_K, conv_dim), 0.5, device),
        "conv_b": full((conv_dim,), 0.0),
        "A_log": a_log.expand(lead + (n_heads,)).contiguous(),
        "dt_bias": full((n_heads,), -2.0),   # softplus(-2) ~ 0.13
        "D": full((n_heads,), 1.0),
        "norm_scale": full((d_inner,), 1.0),
        "w_out": _normal(gen, lead + (d_inner, d_model),
                         1.0 / math.sqrt(d_inner), device),
    }


class MambaState(NamedTuple):
    conv: torch.Tensor   # [B, CONV_K-1, conv_dim] trailing conv inputs (f32)
    s: torch.Tensor      # [B, H, P, N] ssm state (f32)


def init_mamba_state(batch: int, d_model: int, *, d_state: int = 64,
                     head_dim: int = 64, expand: int = 2,
                     device="cuda") -> MambaState:
    device = resolve_device(device)
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * d_state
    return MambaState(
        conv=torch.zeros((batch, CONV_K - 1, conv_dim), dtype=F32,
                         device=device),
        s=torch.zeros((batch, n_heads, head_dim, d_state), dtype=F32,
                      device=device),
    )


def _split_proj(proj, d_inner, d_state, n_heads):
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner: d_inner + d_inner + 2 * d_state]
    dt = proj[..., -n_heads:]
    return z, xbc, dt


def _ssm_step(x, b, c, dt, a_log, d_skip, s):
    """One SSD step. x:[B,H,P] b,c:[B,N] dt:[B,H] s:[B,H,P,N] (all f32)."""
    a = torch.exp(-dt * torch.exp(a_log)[None, :])                   # [B,H]
    dbx = dt[..., None, None] * (x[..., :, None] * b[:, None, None, :])
    s_new = a[..., None, None] * s + dbx                             # [B,H,P,N]
    y = torch.einsum("bhpn,bn->bhp", s_new, c) + d_skip[None, :, None] * x
    return y, s_new


def _ssm_scan(xs, bmat, cmat, dt, a_log, d_skip):
    """``_ssm_step`` over the sequence from a zero state. xs: [B,S,H,P],
    bmat/cmat: [B,S,N], dt: [B,S,H] (f32) -> (y [B,S,H,P], final state
    [B,H,P,N]). When a gradient is to flow, each token's state is a new
    tensor (the same multiply, then the same add), else it is written into
    the chunk's buffer."""
    bsz, seq, n_heads, head_dim = xs.shape
    s = torch.zeros((bsz, n_heads, head_dim, bmat.shape[-1]), dtype=F32,
                    device=xs.device)
    a_all = torch.exp(-dt * torch.exp(a_log)[None, None, :])        # [B,S,H]
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xs, bmat, cmat, dt, a_log, d_skip))
    ys = []
    for t0 in range(0, seq, SCAN_CHUNK):
        span = slice(t0, min(seq, t0 + SCAN_CHUNK))

        def tmajor(t):                      # [B, T, ...] -> [T, B, ...]
            return t[:, span].transpose(0, 1)

        x, b, c, dt_c = tmajor(xs), tmajor(bmat), tmajor(cmat), tmajor(dt)
        a = tmajor(a_all)[..., None, None]                          # [T,B,H,1,1]
        dbx = dt_c[..., None, None] * (x[..., :, None]
                                       * b[:, :, None, None, :])
        if grad:
            # unbind, not a[i]: one backward for the chunk, not one
            # chunk-sized zero fill a token
            steps = []
            for a_i, dbx_i in zip(a.unbind(0), dbx.unbind(0)):
                s = a_i * s + dbx_i
                steps.append(s)
            states = torch.stack(steps)
        else:
            states = torch.empty_like(dbx)                          # [T,B,H,P,N]
            for i in range(dbx.shape[0]):
                s = torch.mul(a[i], s, out=states[i]).add_(dbx[i])
        y = (states @ c[:, :, None, :, None])[..., 0] \
            + d_skip[None, None, :, None] * x
        ys.append(y.transpose(0, 1))
    return torch.cat(ys, dim=1), s.clone()


def _gated_out(params, y, z, d_inner, dtype, eps=1e-5):
    y = y.reshape(*z.shape[:-1], d_inner)
    y = y * F.silu(z.to(F32))
    y = y * torch.rsqrt(torch.mean(torch.square(y), dim=-1, keepdim=True)
                        + eps)
    y = y * params["norm_scale"]
    return y.to(dtype) @ params["w_out"].to(dtype)


def _conv_split(conv, d_inner, d_state):
    conv = F.silu(conv)
    return (conv[..., :d_inner], conv[..., d_inner: d_inner + d_state],
            conv[..., d_inner + d_state:])


def mamba2_train(params, x, *, d_state: int = 64, head_dim: int = 64,
                 expand: int = 2, return_state: bool = False):
    """x: [B, S, D] -> [B, S, D] (or (out, MambaState) with ``return_state``
    — the prefill -> decode handoff). Causal conv + time scan."""
    bsz, seq, d_model = x.shape
    dtype = x.dtype
    d_inner = expand * d_model
    n_heads = d_inner // head_dim

    proj = x @ params["w_in"].to(dtype)
    z, xbc, dt_raw = _split_proj(proj, d_inner, d_state, n_heads)

    # causal depthwise conv over time (kernel CONV_K)
    xbc_f = xbc.to(F32)
    pad = torch.zeros((bsz, CONV_K - 1, xbc.shape[-1]), dtype=F32,
                      device=x.device)
    xp = torch.cat([pad, xbc_f], dim=1)
    conv = sum(
        xp[:, k: k + seq] * params["conv_w"][k][None, None, :]
        for k in range(CONV_K)
    ) + params["conv_b"]
    xs, bmat, cmat = _conv_split(conv, d_inner, d_state)
    xs = xs.reshape(bsz, seq, n_heads, head_dim)
    dt = F.softplus(dt_raw.to(F32) + params["dt_bias"])

    y, s_fin = _ssm_scan(xs, bmat, cmat, dt, params["A_log"], params["D"])
    out = _gated_out(params, y.reshape(bsz, seq, d_inner), z, d_inner, dtype)
    if return_state:
        # decode resumes with the pre-silu conv inputs of the last K-1
        # steps (the zero pad among them for a prompt shorter than K-1)
        return out, MambaState(conv=xp[:, seq: seq + CONV_K - 1].clone(),
                               s=s_fin)
    return out


def mamba2_decode(params, x, state: MambaState, *, d_state: int = 64,
                  head_dim: int = 64, expand: int = 2):
    """One token. x: [B, 1, D] -> ([B, 1, D], new_state). ``state`` is
    read, not written."""
    bsz, _, d_model = x.shape
    dtype = x.dtype
    d_inner = expand * d_model
    n_heads = d_inner // head_dim

    proj = x[:, 0] @ params["w_in"].to(dtype)
    z, xbc, dt_raw = _split_proj(proj, d_inner, d_state, n_heads)

    window = torch.cat([state.conv, xbc.to(F32)[:, None]], dim=1)  # [B,K,C]
    conv = torch.einsum("bkc,kc->bc", window, params["conv_w"]) \
        + params["conv_b"]
    xt, bt, ct = _conv_split(conv, d_inner, d_state)
    dt = F.softplus(dt_raw.to(F32) + params["dt_bias"])

    y, s_new = _ssm_step(xt.reshape(bsz, n_heads, head_dim), bt, ct, dt,
                         params["A_log"], params["D"], state.s)
    out = _gated_out(params, y.reshape(bsz, d_inner), z, d_inner, dtype)
    return out[:, None], MambaState(conv=window[:, 1:], s=s_new)
