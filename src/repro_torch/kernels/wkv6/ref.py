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
kernel computes it. ``chunked_wkv6_backward_reference`` is the gradient of
the chunked version written out as the CUDA backward kernel computes it,
from the state entering each chunk (``chunked_wkv6_reference(...,
chunk_states=True)``).

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


def _chunk_parts(r, k, v, w, u, chunk):
    """The chunked scan's state-independent terms for all chunks at once,
    by name, each ``[BH, nc, L, N]`` unless noted: the inputs in chunks
    (``rc``, ``kc``, ``vc``, ``wc``; ``uc`` [BH, 1, 1, N]), ``logw``,
    ``cum``, ``cum_prev``, ``last`` and ``cref`` ([BH, nc, 1, N]), the
    clipped exponents ``x1`` (r_hat's) and ``x2`` (k_hat's) before the
    clip and their factors ``e1``, ``e2``, ``r_hat``, ``k_hat``, the
    strict causal mask ``causal`` [L, L], ``a`` [BH, nc, L, L], ``bonus``
    [BH, nc, L], ``ecp`` = exp(cum_prev), ``r_dec``, ``etail`` =
    exp(last - cum), ``k_tail``."""
    bh, seq, n = r.shape
    if seq % chunk:
        raise ValueError(f"seq len {seq} must be a multiple of chunk {chunk}")
    nc = seq // chunk

    def chunks(t):
        return t.to(torch.float32).reshape(bh, nc, chunk, n)

    p = {"rc": chunks(r), "kc": chunks(k), "vc": chunks(v), "wc": chunks(w),
         "uc": u.to(torch.float32)[:, None, None, :]}           # [BH,1,1,N]
    p["logw"] = torch.log(torch.clamp_min(p["wc"], 1e-38))
    p["cum"] = torch.cumsum(p["logw"], dim=2)                   # inclusive
    p["cum_prev"] = p["cum"] - p["logw"]                        # exclusive
    p["last"] = p["cum"][:, :, -1:]                             # [BH,nc,1,N]
    p["cref"] = 0.5 * p["last"]
    p["x1"] = p["cum_prev"] - p["cref"]
    p["x2"] = p["cref"] - p["cum"]
    p["e1"] = torch.exp(torch.clamp(p["x1"], -CLAMP, CLAMP))
    p["e2"] = torch.exp(torch.clamp(p["x2"], -CLAMP, CLAMP))
    p["r_hat"] = p["rc"] * p["e1"]
    p["k_hat"] = p["kc"] * p["e2"]
    a = p["r_hat"] @ p["k_hat"].transpose(-1, -2)               # [BH,nc,L,L]
    p["causal"] = torch.ones((chunk, chunk), dtype=torch.bool,
                             device=r.device).tril(-1)          # j < t
    p["a"] = torch.where(p["causal"], a, 0.0)
    p["bonus"] = torch.sum(p["rc"] * p["uc"] * p["kc"], dim=-1)  # [BH,nc,L]
    p["ecp"] = torch.exp(p["cum_prev"])
    p["r_dec"] = p["rc"] * p["ecp"]
    p["etail"] = torch.exp(p["last"] - p["cum"])                # exps <= 0
    p["k_tail"] = p["kc"] * p["etail"]
    return p


def _chunk_terms(r, k, v, w, u, chunk):
    """Everything of the chunked scan that does not depend on the carried
    state, for all chunks at once: ``(intra [BH, nc, L, N], r_dec,
    bonus term [BH, nc, L, N], carry_in [BH, nc, N, N], decay
    [BH, nc, N, 1])``."""
    p = _chunk_parts(r, k, v, w, u, chunk)
    intra = p["a"] @ p["vc"]
    bonus_v = p["bonus"][..., None] * p["vc"]
    carry_in = p["k_tail"].transpose(-1, -2) @ p["vc"]          # [BH,nc,N,N]
    decay = torch.exp(p["last"][:, :, 0, :, None])              # [BH,nc,N,1]
    return intra, p["r_dec"], bonus_v, carry_in, decay


def chunked_wkv6_reference(r, k, v, w, u, *, chunk: int = 16,
                           chunk_states: bool = False):
    """The chunked scan with chunk length ``chunk``; raises ``ValueError``
    when the sequence length is not a multiple of it. Returns (y [BH, S, N]
    in r's dtype, final state [BH, N, N] f32), and with ``chunk_states``
    also the state entering each chunk, [BH, S / chunk, N, N] f32 (the
    first zero): what the backward reads (``chunked_wkv6_backward_
    reference``). The flag changes no bit of y or the final state."""
    bh, seq, n = r.shape
    intra, r_dec, bonus_v, carry_in, decay = _chunk_terms(r, k, v, w, u,
                                                          chunk)
    state = torch.zeros((bh, n, n), dtype=torch.float32, device=r.device)
    ys, kept = [], []
    # a chunk's terms by unbind, not [:, c]: under autograd one backward
    # a term, not a zero fill of the whole term a chunk
    for intra_c, r_dec_c, bonus_c, decay_c, carry_c in zip(
            *(t.unbind(1) for t in (intra, r_dec, bonus_v, decay,
                                    carry_in))):
        kept.append(state)
        ys.append(intra_c + r_dec_c @ state + bonus_c)
        state = decay_c * state + carry_c
    y = (torch.cat(ys, dim=1) if ys
         else torch.zeros((bh, 0, n), dtype=torch.float32, device=r.device))
    if chunk_states:
        s_chunks = (torch.stack(kept, dim=1) if kept else
                    torch.zeros((bh, 0, n, n), dtype=torch.float32,
                                device=r.device))
        return y.to(r.dtype), state, s_chunks
    return y.to(r.dtype), state


def chunked_wkv6_backward_reference(r, k, v, w, u, s_chunks, gy, gs, *,
                                    chunk: int = 16):
    """The gradients of ``chunked_wkv6_reference`` written out, with the
    math of the CUDA backward kernel (``csrc/wkv6_backward.cu``): from the
    inputs, the state entering each chunk (``s_chunks`` [BH, S / chunk,
    N, N], as ``chunked_wkv6_reference(..., chunk_states=True)`` or the
    forward kernel keeps it) and the cotangents of y (``gy`` [BH, S, N])
    and of the final state (``gs`` [BH, N, N]; zeros for an absent one).
    Returns ``(dr, dk, dv, dw, du)``, each of its input's shape, f32.

    A reverse scan over chunks carries dS, the gradient of the state
    leaving the chunk (``gs`` after the last). With S_c the state entering
    chunk c and dy its cotangent rows::

        d r_dec = dy S_c^T            d k_tail = v dS^T
        dv      = k_tail dS + mask(A)^T dy + bonus * dy
        d decay = rowsum(dS * S_c)    dS <- r_dec^T dy + diag(decay) dS

    The rest needs no carry, so it runs for all chunks at once: dA =
    mask(dy v^T), d r_hat = dA k_hat, d k_hat = dA^T r_hat, the bonus
    term's dr, dk and du; then back through the exponents. The clip passes
    zero gradient outside +-25 (``torch.clamp``'s); ``last`` reaches
    ``cref`` (half of it), ``k_tail`` and ``decay``; ``cum`` and
    ``cum_prev`` become d log w by suffix sums inside the chunk; dw = d
    log w / w where w >= 1e-38, else 0 (``torch.clamp_min``'s). The main
    path never calls it: it is the kernel's oracle on the card and its
    decomposition on the CPU."""
    bh, seq, n = r.shape
    p = _chunk_parts(r, k, v, w, u, chunk)
    nc = seq // chunk
    dyc = gy.to(torch.float32).reshape(bh, nc, chunk, n)
    decay = torch.exp(p["last"][:, :, 0, :])                    # [BH,nc,N]
    d_rdec = torch.empty_like(dyc)
    d_ktail = torch.empty_like(dyc)
    dv = torch.empty_like(dyc)
    d_decay = torch.empty_like(decay)
    ds = gs.to(torch.float32).clone()                           # [BH,N,N]
    for c in reversed(range(nc)):
        s_c, dy_c = s_chunks[:, c], dyc[:, c]
        d_rdec[:, c] = dy_c @ s_c.transpose(-1, -2)
        d_ktail[:, c] = p["vc"][:, c] @ ds.transpose(-1, -2)
        dv[:, c] = p["k_tail"][:, c] @ ds
        d_decay[:, c] = (ds * s_c).sum(-1)
        ds = p["r_dec"][:, c].transpose(-1, -2) @ dy_c \
            + decay[:, c, :, None] * ds
    d_a = torch.where(p["causal"], dyc @ p["vc"].transpose(-1, -2), 0.0)
    d_rhat = d_a @ p["k_hat"]
    d_khat = d_a.transpose(-1, -2) @ p["r_hat"]
    d_bonus = (dyc * p["vc"]).sum(-1)[..., None]                # [BH,nc,L,1]
    dv = dv + p["a"].transpose(-1, -2) @ dyc + p["bonus"][..., None] * dyc
    dr = d_rhat * p["e1"] + d_rdec * p["ecp"] + d_bonus * p["uc"] * p["kc"]
    dk = d_khat * p["e2"] + d_ktail * p["etail"] \
        + d_bonus * p["uc"] * p["rc"]
    du = (d_bonus * p["rc"] * p["kc"]).sum(dim=(1, 2))
    # back through the exponents
    d_x1 = torch.where(p["x1"].abs() <= CLAMP, d_rhat * p["r_hat"], 0.0)
    d_x2 = torch.where(p["x2"].abs() <= CLAMP, d_khat * p["k_hat"], 0.0)
    d_tail = d_ktail * p["k_tail"]
    d_cum_prev = d_x1 + d_rdec * p["r_dec"]
    d_cum = -d_x2 - d_tail
    d_last = 0.5 * (d_x2 - d_x1).sum(2) + d_tail.sum(2) \
        + d_decay * decay                                       # [BH,nc,N]
    # d log w[s] = sum_{t >= s} d_cum[t] + sum_{t > s} d_cum_prev[t] + d_last
    suffix = d_cum.flip(2).cumsum(2).flip(2)
    suffix_prev = d_cum_prev.flip(2).cumsum(2).flip(2)
    suffix_prev = torch.cat([suffix_prev[:, :, 1:],
                             torch.zeros_like(suffix_prev[:, :, :1])], dim=2)
    d_logw = suffix + suffix_prev + d_last[:, :, None]
    wc = p["wc"]
    dw = torch.where(wc >= 1e-38, d_logw / torch.clamp_min(wc, 1e-38), 0.0)
    return (dr.reshape(bh, seq, n), dk.reshape(bh, seq, n),
            dv.reshape(bh, seq, n), dw.reshape(bh, seq, n), du)


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
