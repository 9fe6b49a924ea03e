"""Plain PyTorch versions of the Mamba-2 (SSD) selective scan: the CPU
path and the kernels' oracles on the card.

Per batch row and head h, with A_h = exp(A_log_h) and the state
``s`` of ``[P, N]`` starting at zero::

    a_t = exp(-dt_t * A_h)
    s_t = a_t * s_{t-1} + dt_t * (x_t ⊗ b_t)
    y_t = s_t c_t + D_h * x_t

``ssd_scan_reference`` is the reference's ``jax.lax.scan`` over
``repro/models/mamba.py:_ssm_step`` as a token loop (it was
``models/mamba.py:_ssm_scan``). ``ssd_scan_backward_reference`` is its
gradient written out as the reverse recurrence the backward kernel runs
(``csrc/ssd_scan.cu``): the states of each ``CHUNK``-token chunk are
recomputed from the one the forward kept at the chunk's start, then the
state's cotangent runs backward,

    G_t = gy_t c_t^T + a_{t+1} G_{t+1}        (G_{S-1}: + the final
                                               state's cotangent)

and gives, per token, ``g_x = D gy + dt G b``, ``g_b = dt G^T x``,
``g_c = s_t^T gy`` (b and c summed over heads: all heads share them),
``g_dt = x^T G b + g_a * (-A a_t)`` with ``g_a = <G_t, s_{t-1}>``, and
``g_A_log = sum g_a * (-dt A a_t)``, ``g_D = sum gy . x``.

``ssd_scan_chunked_reference`` is the forward kernel's decomposition of
the same recurrence, ``CHUNK`` tokens at a time (an oracle for it; the
op's CPU path stays the token loop): with ``s_in`` the state entering a
chunk, ``l_t = -dt_t A`` and ``cs`` the in-chunk inclusive cumsum of l
(every exponent <= 0, none rebuilt by a division),

    y_t   = sum_{j<=t} (c_t . b_j) exp(cs_t - cs_j) dt_j x_j
            + exp(cs_t) (s_in c_t) + D x_t
    s_out = exp(cs_last) s_in + sum_j exp(cs_last - cs_j) dt_j x_j ⊗ b_j
"""

from __future__ import annotations

import torch

F32 = torch.float32
SCAN_CHUNK = 64    # tokens whose decay and input term are formed at once
CHUNK = 16         # tokens between the states kept for the backward
                   # (csrc/ssd_scan.h: kSsdChunk)


def n_chunks(seq: int) -> int:
    """The states the forward keeps for a sequence of ``seq`` tokens: one
    at the start of each ``CHUNK``-token chunk."""
    return -(-seq // CHUNK)


def ssd_scan_reference(xs, bmat, cmat, dt, a_log, d_skip, *,
                       chunk_states: bool = False):
    """The token recurrence from a zero state. xs: [B,S,H,P],
    bmat/cmat: [B,S,N], dt: [B,S,H] (f32) -> (y [B,S,H,P], final state
    [B,H,P,N]), and with ``chunk_states`` the state entering each
    ``CHUNK``-token chunk ``[B,H,n_chunks(S),P,N]`` (the first zero),
    taken from the same loop. When a gradient is to flow, each token's
    state is a new tensor (the same multiply, then the same add), else it
    is written into the chunk's buffer."""
    bsz, seq, n_heads, head_dim = xs.shape
    s = torch.zeros((bsz, n_heads, head_dim, bmat.shape[-1]), dtype=F32,
                    device=xs.device)
    kept = [s]
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
        if chunk_states:
            # the state after each token that ends a CHUNK, but the last
            kept += [states[t - t0] for t in range(span.start, span.stop)
                     if (t + 1) % CHUNK == 0 and t + 1 < seq]
        y = (states @ c[:, :, None, :, None])[..., 0] \
            + d_skip[None, None, :, None] * x
        ys.append(y.transpose(0, 1))
    out = torch.cat(ys, dim=1), s.clone()
    if chunk_states:
        return (*out, torch.stack(kept, dim=2))
    return out


def ssd_scan_backward_reference(xs, bmat, cmat, dt, a_log, d_skip,
                                s_chunks, gy, gs):
    """The gradients of ``ssd_scan_reference`` (module docstring) from
    the saved inputs, the chunk states the forward kept (``s_chunks``
    [B,H,n_chunks(S),P,N]) and the cotangents of y (``gy`` [B,S,H,P]) and
    of the final state (``gs`` [B,H,P,N]): ``(g_x, g_b, g_c, g_dt,
    g_A_log, g_D)``, each of its input's shape, all f32."""
    bsz, seq, n_heads, head_dim = xs.shape
    big_a = torch.exp(a_log)                                        # [H]
    a_all = torch.exp(-dt * big_a[None, None, :])                   # [B,S,H]
    g = gs.clone()                                                  # G_{t+1}
    a_next = torch.ones_like(a_all[:, 0])                           # a_{t+1}
    g_x = torch.empty_like(xs)
    g_b, g_c = torch.empty_like(bmat), torch.empty_like(cmat)
    g_dt = torch.empty_like(dt)
    g_a_log = torch.zeros_like(a_log)
    g_d = torch.einsum("bshp,bshp->h", gy, xs)
    for k in reversed(range(n_chunks(seq))):
        span = slice(k * CHUNK, min(seq, (k + 1) * CHUNK))
        x, b, c, dt_c, a = xs[:, span], bmat[:, span], cmat[:, span], \
            dt[:, span], a_all[:, span]
        # the chunk's states from the one kept at its start, as the
        # forward rounds them: s_{t-1} (prev) and s_t, [B,T,H,P,N]
        dbx = dt_c[..., None, None] * (x[..., None] * b[:, :, None, None, :])
        s = s_chunks[:, :, k]
        states = []
        for i in range(dbx.shape[1]):
            s = a[:, i, :, None, None] * s + dbx[:, i]
            states.append(s)
        states = torch.stack(states, dim=1)
        prev = torch.cat([s_chunks[:, None, :, k], states[:, :-1]], dim=1)
        # G backward over the chunk, then each token's sums at once
        gyc = gy[:, span, :, :, None] * c[:, :, None, None, :]
        gs_chunk = []
        for i in reversed(range(dbx.shape[1])):
            g = a_next[..., None, None] * g + gyc[:, i]
            gs_chunk.append(g)
            a_next = a[:, i]
        big_g = torch.stack(gs_chunk[::-1], dim=1)                  # [B,T,H,P,N]
        gxb = torch.einsum("bthpn,bthp->bthn", big_g, x)            # G^T x
        g_c[:, span] = torch.einsum("bthpn,bthp->btn", states, gy[:, span])
        g_b[:, span] = torch.einsum("bthn,bth->btn", gxb, dt_c)
        g_x[:, span] = d_skip[None, None, :, None] * gy[:, span] \
            + dt_c[..., None] * torch.einsum("bthpn,btn->bthp", big_g, b)
        g_a = (big_g * prev).sum(dim=(-2, -1))                      # [B,T,H]
        g_dt[:, span] = torch.einsum("bthn,btn->bth", gxb, b) \
            - g_a * big_a * a
        g_a_log -= (g_a * dt_c * big_a * a).sum(dim=(0, 1))
    return g_x, g_b, g_c, g_dt, g_a_log, g_d


def ssd_scan_chunked_reference(xs, bmat, cmat, dt, a_log, d_skip):
    """The scan in the forward kernel's chunk form (module docstring),
    from a zero state: ``(y [B,S,H,P], final state [B,H,P,N], the state
    entering each chunk [B,H,n_chunks(S),P,N])``, f32. The masked decays
    are exp of the cumsums' differences, -inf above the diagonal."""
    bsz, seq, n_heads, head_dim = xs.shape
    big_a = torch.exp(a_log)                                        # [H]
    s = torch.zeros((bsz, n_heads, head_dim, bmat.shape[-1]), dtype=F32,
                    device=xs.device)
    causal = torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                        device=xs.device).tril()
    kept, ys = [], []
    for k in range(n_chunks(seq)):
        span = slice(k * CHUNK, min(seq, (k + 1) * CHUNK))
        x, b, c, dt_c = xs[:, span], bmat[:, span], cmat[:, span], \
            dt[:, span]
        q = x.shape[1]
        kept.append(s)
        cs = torch.cumsum(-dt_c * big_a, dim=1).transpose(1, 2)     # [B,H,Q]
        gap = torch.where(causal[:q, :q], cs[..., :, None] - cs[..., None, :],
                          -torch.inf)                               # [B,H,t,j]
        m = (c @ b.transpose(1, 2))[:, None] * torch.exp(gap) \
            * dt_c.transpose(1, 2)[:, :, None, :]
        y = torch.einsum("bhtj,bjhp->bthp", m, x) \
            + torch.exp(cs).transpose(1, 2)[..., None] \
            * torch.einsum("btn,bhpn->bthp", c, s) \
            + d_skip[None, None, :, None] * x
        last = cs[..., -1]                                          # [B,H]
        w = torch.exp(last[..., None] - cs) * dt_c.transpose(1, 2)  # [B,H,Q]
        s = torch.exp(last)[..., None, None] * s \
            + torch.einsum("bhj,bjhp,bjn->bhpn", w, x, b)
        ys.append(y)
    return torch.cat(ys, dim=1), s, torch.stack(kept, dim=2)
