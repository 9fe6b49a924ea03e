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

The sequence forward's selective scan is one op of the port,
``kernels.ssd.ssd_scan``: a hand-written CUDA kernel on the card (its
backward a second one), the reference's token recurrence on the CPU
(``kernels.ssd.ref.ssd_scan_reference``, the ``jax.lax.scan`` over
``_ssm_step`` as a loop), and a shape function on fake tensors, so the
dry-run traces it once a layer whatever the sequence length. Decode
carries ``MambaState`` — O(1) in sequence length — and runs one
``_ssm_step`` a token, no kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..kernels.ssd import ssd_scan, ssd_scan_reference
from ..sharding.act import local_region
from .layers import _normal

F32 = torch.float32
CONV_K = 4


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


# the plain token loop (the CPU path of ``ssd_scan``)
_ssm_scan = ssd_scan_reference


def _local_scan(*args):
    return ssd_scan(*(t.contiguous() for t in args))


def _scan(xs, bmat, cmat, dt, a_log, d_skip):
    """``ssd_scan`` (on contiguous copies: xs, b and c are slices of the
    conv's output); on a mesh (the dry-run) each rank scans its own batch
    rows and heads (``sharding.act.local_region``)."""
    b, _, h, p = xs.shape
    heads = ("batch", None, "model", None)
    return local_region(
        _local_scan,
        (heads, ("batch", None, None), ("batch", None, None),
         ("batch", None, "model"), ("model",), ("model",)),
        [(tuple(xs.shape), heads),
         ((b, h, p, bmat.shape[-1]), ("batch", "model", None, None))],
    )(xs, bmat, cmat, dt, a_log, d_skip)


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

    y, s_fin = _scan(xs, bmat, cmat, dt, params["A_log"], params["D"])
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
