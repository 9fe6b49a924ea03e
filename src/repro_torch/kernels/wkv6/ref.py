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
only the carry loops over chunks. ``segmented_wkv6_reference`` is the same
scan cut into segments of chunks, carried segment to segment, as the CUDA
kernel computes it.

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


def _chunk_terms(r, k, v, w, u, chunk):
    """Everything of the chunked scan that does not depend on the carried
    state, for all chunks at once: ``(intra [BH, nc, L, N], r_dec,
    bonus term [BH, nc, L, N], carry_in [BH, nc, N, N], decay
    [BH, nc, N, 1])``."""
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
    return intra, r_dec, bonus_v, carry_in, decay


def chunked_wkv6_reference(r, k, v, w, u, *, chunk: int = 16):
    """The chunked scan with chunk length ``chunk``; raises ``ValueError``
    when the sequence length is not a multiple of it. Returns (y [BH, S, N]
    in r's dtype, final state [BH, N, N] f32)."""
    bh, seq, n = r.shape
    intra, r_dec, bonus_v, carry_in, decay = _chunk_terms(r, k, v, w, u,
                                                          chunk)
    state = torch.zeros((bh, n, n), dtype=torch.float32, device=r.device)
    ys = []
    # a chunk's terms by unbind, not [:, c]: under autograd one backward
    # a term, not a zero fill of the whole term a chunk
    for intra_c, r_dec_c, bonus_c, decay_c, carry_c in zip(
            *(t.unbind(1) for t in (intra, r_dec, bonus_v, decay,
                                    carry_in))):
        ys.append(intra_c + r_dec_c @ state + bonus_c)
        state = decay_c * state + carry_c
    y = (torch.cat(ys, dim=1) if ys
         else torch.zeros((bh, 0, n), dtype=torch.float32, device=r.device))
    return y.to(r.dtype), state


def segmented_wkv6_reference(r, k, v, w, u, *, chunk: int = 16,
                             segment: int = 1):
    """The chunked scan split as the CUDA kernel splits it: each bh's
    chunks cut into segments of ``segment`` chunks (the last may be
    shorter), then three passes.

    1. Each segment but the last runs the carry from a zero state: its own
       contribution ``S_loc`` and its total decay ``P``, the product of its
       chunks' ``exp(cum[L-1])`` in chunk order.
    2. Over the segments in order: ``S_in[0] = 0``, ``S_in[s] = P[s-1]
       S_in[s-1] + S_loc[s-1]``.
    3. Each segment runs the chunked scan from ``S_in[s]``: y, and, in the
       last, the final state.

    Exact algebra: the clip stays inside each chunk, so this is the
    chunked scan's function with another rounding order. Used by the tests
    and ``chip_smoke.py`` as the kernel's decomposition on the CPU; the
    main path never calls it. Returns (y [BH, S, N] in r's dtype, final
    state [BH, N, N] f32)."""
    if segment < 1:
        raise ValueError(f"segment {segment} must be at least one chunk")
    bh, seq, n = r.shape
    intra, r_dec, bonus_v, carry_in, decay = _chunk_terms(r, k, v, w, u,
                                                          chunk)
    nc = seq // chunk
    nseg = max(1, -(-nc // segment))
    state = torch.zeros((bh, n, n), dtype=torch.float32, device=r.device)
    s_in = [state]
    for s in range(nseg - 1):                    # passes 1 and 2
        s_loc = torch.zeros_like(state)
        p = torch.ones((bh, n, 1), dtype=torch.float32, device=r.device)
        for c in range(s * segment, (s + 1) * segment):
            s_loc = decay[:, c] * s_loc + carry_in[:, c]
            p = p * decay[:, c]
        s_in.append(p * s_in[-1] + s_loc)
    ys = []
    for s in range(nseg):                        # pass 3
        state = s_in[s]
        for c in range(s * segment, min((s + 1) * segment, nc)):
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
