"""The wkv6 scan's written-out backward (``chunked_wkv6_backward_reference``,
the math of the CUDA backward kernel) and its chunk-state companion, on
the CPU.

The written-out backward is held to autograd through the plain chunked
version (``chunked_wkv6_reference``) and to ``jax.grad`` through the JAX
package's chunked twin (``repro.models.rwkv._wkv_chunked``): dr, dk, dv,
du and d log w = dw * w each within 1e-5 of their largest magnitude
against autograd, within the LM bar (1e-4) against JAX; dw exactly 0
where w < 1e-38 (``torch.clamp_min``'s gradient). Inputs are numpy draws
from a seed: the model's decays, a channel of each head whose chunks
decay past the +-25 clip and some decays exactly 0. The kernel itself is
held to these on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 46); on the CPU the ``wkv6`` wrapper's gradient stays autograd's
through the plain version (``tests/test_torch_lm_train.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.wkv6 import (chunked_wkv6_backward_reference,
                                      chunked_wkv6_reference, clipped_chunks,
                                      wkv6)
from repro_torch.kernels.wkv6.ref import _chunk_terms
from repro_torch.models import rwkv
from test_torch_lm_train import LM_BAR, _heads, _jax_wkv_grads, _wkv_streams

BAR = 1e-5


def _inputs(bh, seq, n, seed, zero_frac=0.05):
    """r, k, v ~ N(0, 1); w = exp(-exp(wlog)), wlog ~ N(-0.6, 1) and 3.0
    in the last channel (a total log decay of ~-80 over 4 steps, past the
    clip's -50); ``zero_frac`` of the decays exactly 0; u ~ N(0, 0.25);
    the cotangents of y and of the final state ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((bh, seq, n)) for _ in range(3))
    wlog = -0.6 + rng.standard_normal((bh, seq, n))
    wlog[..., n - 1] = 3.0
    w = np.exp(-np.exp(wlog))
    w = np.where(rng.random((bh, seq, n)) < zero_frac, 0.0, w)
    u = 0.5 * rng.standard_normal((bh, n))
    gy = rng.standard_normal((bh, seq, n))
    gs = rng.standard_normal((bh, n, n))
    return [torch.from_numpy(a.astype(np.float32))
            for a in (r, k, v, w, u, gy, gs)]


def _rel(got, want):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    return err / scale if scale else err


@pytest.mark.parametrize("cot", ["y", "state", "both"])
@pytest.mark.parametrize("chunk", [16, 4])
@pytest.mark.parametrize("n", [8, 64])
@pytest.mark.parametrize("seq", [16, 64, 160])
def test_torch_wkv6_backward_reference_matches_autograd(seq, n, chunk, cot):
    """The written-out backward, from the companion's chunk states,
    against autograd through the plain chunked version, for y's cotangent,
    the final state's or both (an absent one passed as zeros)."""
    r, k, v, w, u, gy, gs = _inputs(2, seq, n, seed=seq + n + chunk)
    assert clipped_chunks(w, chunk=chunk) > 0 and bool((w == 0).any())
    gy = gy if cot != "state" else torch.zeros_like(gy)
    gs = gs if cot != "y" else torch.zeros_like(gs)
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    y, s = chunked_wkv6_reference(*ins, chunk=chunk)
    want = torch.autograd.grad((y * gy).sum() + (s * gs).sum(), ins)
    with torch.no_grad():
        kept = chunked_wkv6_reference(r, k, v, w, u, chunk=chunk,
                                      chunk_states=True)[2]
        got = chunked_wkv6_backward_reference(r, k, v, w, u, kept, gy, gs,
                                              chunk=chunk)
    assert all(g.shape == t.shape and g.dtype == torch.float32
               for g, t in zip(got, (r, k, v, w, u)))
    for name, g, a in zip("rkvu", got[:3] + got[4:], want[:3] + want[4:]):
        assert _rel(g, a) <= BAR, f"d{name}: {_rel(g, a):.3e}"
    assert _rel(got[3] * w, want[3] * w) <= BAR      # d log w
    dead = w < 1e-38
    assert bool((got[3][dead] == 0).all()) and bool((want[3][dead] == 0).all())
    assert bool(torch.isfinite(got[3]).all())


@pytest.mark.parametrize("seq", [64, 50])
def test_torch_wkv6_backward_reference_matches_jax(seq, monkeypatch):
    """Through the model's chunked backend (``rwkv._wkv_chunked``: heads,
    the pad of S = 50 to 64 with w = 1, ``w = exp(-exp(wlog))``) with the
    written-out backward in the wkv6 call's place, against ``jax.grad``
    through JAX's chunked twin: the gradients of r, k, v, wlog and u each
    within 1e-4 of their largest value; some chunk-channels break the
    clip."""

    class WrittenOut(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r, k, v, w, u, chunk):
            y, s, kept = chunked_wkv6_reference(r, k, v, w, u, chunk=chunk,
                                                chunk_states=True)
            ctx.save_for_backward(r, k, v, w, u, kept)
            ctx.chunk = chunk
            return y, s

        @staticmethod
        def backward(ctx, gy, gs):
            *ins, kept = ctx.saved_tensors
            grads = chunked_wkv6_backward_reference(
                *ins, kept, gy.contiguous(), gs.contiguous(),
                chunk=ctx.chunk)
            return (*grads, None)

    monkeypatch.setattr(rwkv, "wkv6", lambda r, k, v, w, u, *, chunk=16:
                        WrittenOut.apply(r, k, v, w, u, chunk))
    arrays, cot, n_heads = _wkv_streams(seq, seed=seq + 1)
    want = _jax_wkv_grads(arrays, cot, n_heads)
    r, k, v, wlog, u = (torch.from_numpy(a).requires_grad_() for a in arrays)
    w = torch.exp(-torch.exp(wlog))
    assert clipped_chunks(_heads(w.detach(), n_heads)) > 0
    y, _ = rwkv._wkv_chunked({"u": u}, n_heads, r, k, v, w)
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                              (r, k, v, wlog, u))
    for name, a, b in zip("rkvwu", want, got):
        a = torch.from_numpy(np.array(a))
        assert _rel(b, a) <= LM_BAR, f"d{name}: {_rel(b, a):.3e}"


@pytest.mark.parametrize("bh,seq,n,chunk", [(2, 64, 16, 16), (1, 48, 8, 4),
                                            (3, 16, 24, 16), (2, 0, 8, 16)])
def test_torch_wkv6_chunk_states_companion(bh, seq, n, chunk):
    """The companion's y and final state are the flag-off call's bits;
    its first state is zero; each kept state run through its chunk gives
    the next, and the last gives the final state, bitwise; the state
    entering chunk c is the final state of the scan over the first c
    chunks."""
    r, k, v, w, u, _, _ = _inputs(bh, seq, n, seed=bh + seq + n)
    y0, s0 = chunked_wkv6_reference(r, k, v, w, u, chunk=chunk)
    y, s, kept = chunked_wkv6_reference(r, k, v, w, u, chunk=chunk,
                                        chunk_states=True)
    nc = seq // chunk
    assert tuple(kept.shape) == (bh, nc, n, n)
    assert torch.equal(y, y0) and torch.equal(s, s0)
    if not nc:
        return
    assert not bool(kept[:, 0].any())
    _, _, _, carry_in, decay = _chunk_terms(r, k, v, w, u, chunk)
    nxt = [decay[:, c] * kept[:, c] + carry_in[:, c] for c in range(nc)]
    for c in range(nc - 1):
        assert torch.equal(nxt[c], kept[:, c + 1])
    assert torch.equal(nxt[-1], s)
    for c in range(1, nc):
        cut = c * chunk
        _, s_c = chunked_wkv6_reference(r[:, :cut].contiguous(),
                                        k[:, :cut].contiguous(),
                                        v[:, :cut].contiguous(),
                                        w[:, :cut].contiguous(), u,
                                        chunk=chunk)
        torch.testing.assert_close(s_c, kept[:, c], rtol=1e-6, atol=1e-6)


def test_torch_wkv6_cpu_backward_launches_no_kernel(monkeypatch):
    """On the CPU the wrapper launches no kernel either way, and under
    ``torch.no_grad`` (or with no input needing a gradient) it returns the
    plain version's bits without building a graph."""
    monkeypatch.setattr(wkv6, "launches", 0)
    monkeypatch.setattr(wkv6, "backward_launches", 0)
    r, k, v, w, u, gy, gs = _inputs(2, 32, 16, seed=3)
    want = chunked_wkv6_reference(r, k, v, w, u)
    with torch.no_grad():
        got = wkv6(*[t.clone().requires_grad_() for t in (r, k, v, w, u)])
    assert all(torch.equal(a, b) and a.grad_fn is None
               for a, b in zip(got, want))
    got = wkv6(r, k, v, w, u)
    assert all(torch.equal(a, b) and a.grad_fn is None
               for a, b in zip(got, want))
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    y, s = wkv6(*ins)
    torch.autograd.grad((y * gy).sum() + (s * gs).sum(), ins)
    assert (wkv6.launches, wkv6.backward_launches) == (0, 0)
