"""Plain PyTorch versions of the WKV6 scan: the CPU path and the kernel's
oracles on the card.

``wkv6_reference`` is the exact token recurrence (the JAX package's
``repro/kernels/wkv6/ref.py``)::

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

``chunked_wkv6_reference`` is the chunked factorisation step for step as
the TPU kernel's body computes it (``repro/kernels/wkv6/wkv6.py:_kernel``):
the same ``log(max(w, 1e-38))``, mid-chunk reference, +-25 clip, strict
causal mask, bonus term and unclipped inter-chunk carry. Everything that
does not depend on the carried state is computed for all chunks at once;
only the carry loops over chunks.

The factorisation equals the recurrence only while its exponents stay
inside the clip: every channel's total log decay over every chunk must be
at least ``-2 * CLAMP`` (the TPU kernel's own condition).
``clipped_chunks`` counts the (bh, chunk, channel) triples that break it;
there y is not the recurrence's (the final state, carried unclipped,
still is).
"""

from __future__ import annotations

import torch

CLAMP = 25.0


def wkv6_reference(r, k, v, w, u):
    """r/k/v/w: [BH, S, N]; u: [BH, N]. Returns (y [BH, S, N] in r's dtype,
    final state [BH, N, N] f32)."""
    bh, seq, n = r.shape
    rf, kf, vf, wf = (t.to(torch.float32) for t in (r, k, v, w))
    state = torch.zeros((bh, n, n), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(seq):
        kv = kf[:, t, :, None] * vf[:, t, None, :]              # [BH, N, N]
        ys.append(torch.einsum("bn,bnm->bm", rf[:, t],
                               state + u[:, :, None] * kv))
        state = wf[:, t, :, None] * state + kv
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((bh, 0, n), dtype=torch.float32, device=r.device))
    return y.to(r.dtype), state


def chunked_wkv6_reference(r, k, v, w, u, *, chunk: int = 16):
    """The chunked scan with chunk length ``chunk``; raises ``ValueError``
    when the sequence length is not a multiple of it. Returns (y [BH, S, N]
    in r's dtype, final state [BH, N, N] f32)."""
    bh, seq, n = r.shape
    if seq % chunk:
        raise ValueError(f"seq len {seq} must be a multiple of chunk {chunk}")
    nc = seq // chunk

    def chunks(t):
        return t.to(torch.float32).reshape(bh, nc, chunk, n)

    rc, kc, vc, wc = chunks(r), chunks(k), chunks(v), chunks(w)
    uc = u.to(torch.float32)[:, None, None, :]                  # [BH,1,1,N]

    logw = torch.log(torch.clamp_min(wc, 1e-38))
    cum = torch.cumsum(logw, dim=2)                             # inclusive
    cum_prev = cum - logw                                       # exclusive
    last = cum[:, :, -1:]                                       # [BH,nc,1,N]
    cref = 0.5 * last

    r_hat = rc * torch.exp(torch.clamp(cum_prev - cref, -CLAMP, CLAMP))
    k_hat = kc * torch.exp(torch.clamp(cref - cum, -CLAMP, CLAMP))
    a = r_hat @ k_hat.transpose(-1, -2)                         # [BH,nc,L,L]
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=r.device).tril(-1)               # j < t
    a = torch.where(causal, a, 0.0)
    bonus = torch.sum(rc * uc * kc, dim=-1)                     # [BH,nc,L]

    intra = a @ vc
    r_dec = rc * torch.exp(cum_prev)
    bonus_v = bonus[..., None] * vc
    k_tail = kc * torch.exp(last - cum)                         # exps <= 0
    carry_in = k_tail.transpose(-1, -2) @ vc                    # [BH,nc,N,N]
    decay = torch.exp(last[:, :, 0, :, None])                   # [BH,nc,N,1]

    state = torch.zeros((bh, n, n), dtype=torch.float32, device=r.device)
    ys = []
    for c in range(nc):
        ys.append(intra[:, c] + r_dec[:, c] @ state + bonus_v[:, c])
        state = decay[:, c] * state + carry_in[:, c]
    y = (torch.cat(ys, dim=1) if ys
         else torch.zeros((bh, 0, n), dtype=torch.float32, device=r.device))
    return y.to(r.dtype), state


def clipped_chunks(w, *, chunk: int = 16) -> int:
    """The number of (bh, chunk, channel) triples whose total log decay is
    below ``-2 * CLAMP``: 0 when the chunked scan is exact for ``w``."""
    bh, seq, n = w.shape
    logw = torch.log(torch.clamp_min(w.to(torch.float32), 1e-38))
    total = logw.reshape(bh, seq // chunk, chunk, n).sum(dim=2)
    return int((total < -2 * CLAMP).sum())
