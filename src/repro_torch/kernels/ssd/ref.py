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

``ssd_scan_backward_chunked_reference`` is the backward kernel's chunk
form of the gradient (an oracle for it; the op's CPU path stays the
written-out recurrence). Over the chunks in reverse, with G^ the
cotangent arriving from the later chunks (the final state's for the
last), E(i, t) = exp(cs_i - cs_t) and every exponent <= 0:

    G_t     = sum_{i>=t} E(i, t) gy_i c_i^T + exp(cs_last - cs_t) G^
    G^     <- exp(cs_last) G^ + sum_i exp(cs_i) gy_i c_i^T     (the carry)
    G_t b_t = sum_{i>=t} E(i, t) (c_i . b_t) gy_i + exp(cs_last - cs_t) G^ b_t
    G_t^T x_t = sum_{i>=t} E(i, t) (gy_i . x_t) c_i
                + exp(cs_last - cs_t) G^T x_t
    s_t^T gy_t = exp(cs_t) s_in^T gy_t
                 + sum_{j<=t} E(t, j) dt_j (x_j . gy_t) b_j

and the log decay's gradient g_l_t = <G_t, a_t s_{t-1}>, where a_t
s_{t-1} = s_t - dt_t x_t b_t^T is s_t's sums with j < t, so no term is
a difference of two large ones:

    g_l_t = sum_{i>=t>j} exp(cs_i - cs_j) dt_j (c_i . b_j)(gy_i . x_j)
            + sum_{i>=t} exp(cs_i) gy_i^T s_in c_i
            + sum_{j<t} exp(cs_last - cs_j) dt_j x_j^T G^ b_j
            + exp(cs_last) <G^, s_in>

g_x = D gy + dt G b, g_b = dt G^T x and g_c = s^T gy (summed over
heads), g_dt = x^T G b - A g_l, g_A_log = -sum g_l dt A, g_D = sum gy . x.
Its cumsums are taken in f64, as the kernel takes them, so that a gap
cs_i - cs_j is rounded as the sum of its own l's and not as the chunk's.
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


def ssd_scan_backward_chunked_reference(xs, bmat, cmat, dt, a_log, d_skip,
                                        s_chunks, gy, gs):
    """The gradients of the scan in the backward kernel's chunk form
    (module docstring), from the same arguments as
    ``ssd_scan_backward_reference``: ``(g_x, g_b, g_c, g_dt, g_A_log,
    g_D)``, f32. The masked decays are exp of the cumsums' differences,
    -inf outside their triangle."""
    bsz, seq, n_heads, head_dim = xs.shape
    big_a = torch.exp(a_log)                                        # [H]
    g_hat = gs.clone()                                              # [B,H,P,N]
    causal = torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                        device=xs.device).tril()                    # [t, j]: j <= t
    g_x, g_dt = torch.empty_like(xs), torch.empty_like(dt)
    g_b, g_c = torch.empty_like(bmat), torch.empty_like(cmat)
    g_a_log = torch.zeros_like(a_log)
    for k in reversed(range(n_chunks(seq))):
        span = slice(k * CHUNK, min(seq, (k + 1) * CHUNK))
        x, gyc, b, c, dt_c = xs[:, span], gy[:, span], bmat[:, span], \
            cmat[:, span], dt[:, span]
        q = x.shape[1]
        s_in = s_chunks[:, :, k]                                    # [B,H,P,N]
        low, strict = causal[:q, :q], causal[:q, :q].tril(-1)
        # the cumsums in f64, so that a gap cs_t - cs_j is as exact as the
        # sum of its own l's (in f32 it would carry the rounding of the
        # whole chunk's sum: ~1e-5 of a decay at dt A ~ 200 a token)
        cs64 = torch.cumsum((-dt_c * big_a).double(), dim=1).transpose(1, 2)
        cs, last64 = cs64.float(), cs64[..., -1:]                   # [B,H,Q]
        last = last64.float()                                       # [B,H,1]
        dt_h = dt_c.transpose(1, 2)                                 # [B,H,Q]
        diff = (cs64[..., :, None] - cs64[..., None, :]).float()    # [t][j]: cs_t - cs_j

        def decay(mask):
            return torch.exp(torch.where(mask, diff, -torch.inf))

        e_lo = decay(low)                                           # E(t, j), j <= t
        e_up = e_lo.transpose(-1, -2)                               # [t][i]: E(i, t), i >= t
        cb = cmat[:, span] @ b.transpose(1, 2)                      # [B,i,j]: c_i . b_j
        w = torch.einsum("bihp,bjhp->bhij", gyc, x)                 # gy_i . x_j
        tail = torch.exp((last64 - cs64).float())                   # [B,H,Q]
        g_hat_b = torch.einsum("btn,bhpn->bthp", b, g_hat)          # G^ b_t
        g_hat_x = torch.einsum("bthp,bhpn->bthn", x, g_hat)         # G^T x_t
        gy_s = torch.einsum("bthp,bhpn->bthn", gyc, s_in)           # s_in^T gy_t
        gb = torch.einsum("bhti,bit,bihp->bthp", e_up, cb, gyc) \
            + tail.transpose(1, 2)[..., None] * g_hat_b              # G_t b_t
        gtx = torch.einsum("bhti,bhit,bin->bthn", e_up, w, c) \
            + tail.transpose(1, 2)[..., None] * g_hat_x              # G_t^T x_t
        stg = torch.einsum("bhtj,bhtj,bhj,bjn->bthn", e_lo, w, dt_h, b) \
            + torch.exp(cs).transpose(1, 2)[..., None] * gy_s        # s_t^T gy_t
        # g_l's four sums
        kk = decay(strict) * dt_h[:, :, None, :] * cb[:, None] * w  # [B,H,i,j], j < i
        at_or_after = low.transpose(0, 1).to(F32)                   # [t][i]: i >= t
        before = strict.to(F32)                                     # [t][j]: j < t
        g_l = torch.einsum("ti,bhij,tj->bht", at_or_after, kk, before)
        u = torch.einsum("bthn,btn->bht", gy_s, c)                  # gy_i^T s_in c_i
        v = torch.einsum("bthn,btn->bht", g_hat_x, b)               # x_j^T G^ b_j
        g_l = g_l + torch.einsum("ti,bhi->bht", at_or_after,
                                 torch.exp(cs) * u) \
            + torch.einsum("tj,bhj->bht", before,
                           tail * dt_h * v) \
            + torch.exp(last) * (g_hat * s_in).sum(dim=(-2, -1))[..., None]
        g_l = g_l.transpose(1, 2)                                   # [B,Q,H]
        g_x[:, span] = d_skip[None, None, :, None] * gyc \
            + dt_c[..., None] * gb
        g_b[:, span] = torch.einsum("bthn,bth->btn", gtx, dt_c)
        g_c[:, span] = stg.sum(dim=2)
        g_dt[:, span] = torch.einsum("bthp,bthp->bth", x, gb) - big_a * g_l
        g_a_log -= (g_l * dt_c * big_a).sum(dim=(0, 1))
        g_hat = torch.exp(last)[..., None] * g_hat \
            + torch.einsum("bhi,bihp,bin->bhpn", torch.exp(cs), gyc, c)
    return g_x, g_b, g_c, g_dt, g_a_log, torch.einsum("bshp,bshp->h", gy, xs)
