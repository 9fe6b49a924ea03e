"""The port's WKV6 scan against the JAX package, on the CPU.

The same numpy inputs go through the JAX kernel (``repro.kernels.wkv6.wkv6``,
the Pallas kernel in interpret mode), the JAX reference (the exact token
recurrence) and the port's two plain versions and wrapper. The bar is the
JAX kernel test's own: max |dy| / max |y| < 1e-4, and the final state
within rtol 1e-3 / atol 1e-4. The CUDA kernel itself is held to the plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import reference as jax_reference
from repro.kernels.wkv6 import wkv6 as jax_wkv6
from repro.models import rwkv as jax_rwkv
from repro_torch.kernels.extension import CUDA_FLAGS
from repro_torch.kernels.wkv6 import (chunked_wkv6_reference, clipped_chunks,
                                      segmented_wkv6_reference, wkv6,
                                      wkv6_reference)
from repro_torch.kernels.wkv6.wkv6 import segment_chunks
from repro_torch.models import rwkv

SWEEP = [(2, 32, 16), (4, 64, 32), (1, 128, 64), (8, 48, 8)]


def _inputs(bh, seq, n, seed, zero_frac=0.0, wlog_mean=-0.6):
    """r, k, v ~ N(0, 1); w = exp(-exp(wlog)), wlog ~ N(-0.6, 1), the JAX
    tests' realistic RWKV-6 decays (``wlog_mean`` shifts them; wlog is
    capped at 4, so w >= 1.9e-24 stays a normal float); u ~ N(0, 0.01);
    ``zero_frac`` of the decays set to exactly 0."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((bh, seq, n)) for _ in range(3))
    wlog = np.minimum(wlog_mean + rng.standard_normal((bh, seq, n)), 4.0)
    w = np.exp(-np.exp(wlog))
    w = np.where(rng.random((bh, seq, n)) < zero_frac, 0.0, w)
    u = 0.1 * rng.standard_normal((bh, n))
    return [a.astype(np.float32) for a in (r, k, v, w, u)]


def _jax(fn, arrays, **kw):
    y, s = fn(*(jnp.asarray(a) for a in arrays), **kw)
    return np.asarray(y), np.asarray(s)


def _torch(fn, arrays, **kw):
    y, s = fn(*(torch.from_numpy(a) for a in arrays), **kw)
    return y.numpy(), s.numpy()


def _assert_bar(got, want):
    (y, s), (y_ref, s_ref) = got, want
    scale = float(np.max(np.abs(y_ref))) + 1e-6
    assert float(np.max(np.abs(y - y_ref))) / scale < 1e-4
    np.testing.assert_allclose(s, s_ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("bh,seq,n", SWEEP)
def test_torch_wkv6_sweep_matches_jax(bh, seq, n, monkeypatch):
    """Both plain versions against the Pallas kernel and the JAX reference;
    the wrapper on CPU tensors is the chunked plain version, launching no
    kernel."""
    monkeypatch.setattr(wkv6, "launches", 0)
    inp = _inputs(bh, seq, n, seed=bh * seq + n)
    jax_out = [_jax(jax_wkv6, inp), _jax(jax_reference, inp)]
    chunked = _torch(chunked_wkv6_reference, inp)
    exact = _torch(wkv6_reference, inp)
    for got in (chunked, exact):
        for want in jax_out:
            _assert_bar(got, want)
    wrapped = _torch(wkv6, inp)
    assert all(np.array_equal(a, b) for a, b in zip(wrapped, chunked))
    assert wkv6.launches == 0


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_torch_wkv6_chunk_matches_jax(chunk):
    inp = _inputs(2, 64, 16, seed=7)
    want = _jax(jax_reference, inp)
    for got in (_torch(chunked_wkv6_reference, inp, chunk=chunk),
                _torch(wkv6, inp, chunk=chunk)):
        _assert_bar(got, _jax(jax_wkv6, inp, chunk=chunk))
        _assert_bar(got, want)


def test_torch_wkv6_zero_decays():
    """Exact zeros in w. The exact recurrence matches JAX's at the bar. The
    chunked scan stays finite (its 1e-38 floor is a subnormal that PyTorch
    keeps; XLA on the CPU flushes it to 0, so the JAX kernel's output there
    is NaN and is not compared) and its final state, carried unclipped,
    matches the exact one; its y does not (a zero decay pushes the
    factorisation past the +-25 clip, in the JAX kernel's algorithm too)."""
    inp = _inputs(2, 64, 16, seed=5, zero_frac=0.05)
    assert (inp[3] == 0).any()
    want = _jax(jax_reference, inp)
    _assert_bar(_torch(wkv6_reference, inp), want)
    y, s = _torch(chunked_wkv6_reference, inp)
    assert np.isfinite(y).all()
    np.testing.assert_allclose(s, want[1], rtol=1e-3, atol=1e-4)


def test_torch_wkv6_clipped_matches_jax():
    """Strong decays (wlog ~ N(1.5, 1)) push many chunk-channels past the
    factorisation's +-25 clip, so the chunked scan's y is no longer the
    recurrence's. The port's chunked plain version and wrapper still
    compute what the JAX Pallas kernel (interpret mode) and the JAX model's
    chunked twin (``rwkv._wkv_chunked``) compute, at the bar; the final
    state, carried unclipped, is the recurrence's."""
    b, h, seq, n = 2, 4, 64, 16
    r, k, v, w, _ = _inputs(b * h, seq, n, seed=21, wlog_mean=1.5)
    u = (0.1 * np.random.default_rng(22).standard_normal(h * n)).astype(
        np.float32)
    inp = [r, k, v, w, np.tile(u.reshape(h, n), (b, 1))]
    assert clipped_chunks(torch.from_numpy(w)) > 0
    exact = _jax(jax_reference, inp)
    chunked = _torch(chunked_wkv6_reference, inp)
    scale = float(np.max(np.abs(exact[0])))
    assert float(np.max(np.abs(chunked[0] - exact[0]))) / scale > 1e-3
    np.testing.assert_allclose(chunked[1], exact[1], rtol=1e-3, atol=1e-4)
    for got in (chunked, _torch(wkv6, inp)):
        _assert_bar(got, _jax(jax_wkv6, inp))

    def model_layout(t):   # [B*H, S, N] -> [B, S, H*N]
        return t.reshape(b, h, seq, n).transpose(0, 2, 1, 3).reshape(
            b, seq, h * n)

    twin = np.asarray(jax_rwkv._wkv_chunked(
        {"u": jnp.asarray(u)}, h, *(jnp.asarray(model_layout(t))
                                    for t in (r, k, v, w))))
    y = chunked[0].reshape(b, h, seq, n).transpose(0, 2, 1, 3)
    assert float(np.max(np.abs(y - twin))) / scale < 1e-4
    port, s_fin = rwkv._wkv_chunked(
        {"u": torch.from_numpy(u)}, h,
        *(torch.from_numpy(model_layout(t)) for t in (r, k, v, w)))
    assert np.array_equal(port.numpy(), y)
    np.testing.assert_array_equal(s_fin.numpy().reshape(b * h, n, n),
                                  chunked[1])


@pytest.mark.parametrize("bh,seq,n,chunk,segment", [
    (2, 64, 16, 16, 1),      # one chunk a segment
    (4, 64, 32, 8, 2),       # two
    (2, 96, 16, 8, 3),       # three: 12 chunks, 4 whole segments
    (2, 80, 16, 8, 3),       # ragged: 10 chunks, the last segment 1
    (2, 16, 16, 16, 2),      # a single chunk, shorter than a segment
    (1, 128, 64, 16, 3),     # BH = 1, ragged: 8 chunks
])
def test_torch_wkv6_segmented_matches_chunked(bh, seq, n, chunk, segment):
    """The kernel's decomposition (segments of whole chunks, a carry over
    the segments, the scan from each segment's incoming state) is the
    chunked scan with another rounding order: y within 1e-6 of max |y|,
    the state within rtol 1e-5 (atol 1e-7 for entries near zero)."""
    inp = [torch.from_numpy(a) for a in _inputs(bh, seq, n, seed=seq + n)]
    y, s = segmented_wkv6_reference(*inp, chunk=chunk, segment=segment)
    y_ref, s_ref = chunked_wkv6_reference(*inp, chunk=chunk)
    scale = float(y_ref.abs().max())
    assert float((y - y_ref).abs().max()) / scale < 1e-6
    torch.testing.assert_close(s, s_ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("segment", [1, 2, 3])
@pytest.mark.parametrize("bh,seq,n", SWEEP)
def test_torch_wkv6_segmented_matches_jax(bh, seq, n, segment):
    """The segmented plain version against the JAX Pallas kernel
    (interpret mode) at the JAX kernel test's bar, on the sweep shapes."""
    inp = _inputs(bh, seq, n, seed=bh * seq + n)
    _assert_bar(_torch(segmented_wkv6_reference, inp, segment=segment),
                _jax(jax_wkv6, inp))


@pytest.mark.parametrize("segment", [1, 3])
def test_torch_wkv6_segmented_clipped_matches_jax(segment):
    """The all-clipped case of ``test_torch_wkv6_clipped_matches_jax``
    (wlog ~ N(1.5, 1)): the segmented plain version computes the JAX
    Pallas kernel's clipped y, at the bar."""
    inp = _inputs(8, 64, 16, seed=21, wlog_mean=1.5)
    assert clipped_chunks(torch.from_numpy(inp[3])) > 0
    _assert_bar(_torch(segmented_wkv6_reference, inp, segment=segment),
                _jax(jax_wkv6, inp))


def test_torch_wkv6_segment_choice():
    """Segments of whole chunks; one segment when BH gives every SM a
    block; otherwise enough segments for several waves, and never more
    than the chunks."""
    assert segment_chunks(256, 256, 132) == 256
    assert segment_chunks(64, 0, 132) == 1
    assert segment_chunks(1, 1, 132) == 1
    seg = segment_chunks(64, 2048, 132)
    segs = -(-2048 // seg)
    assert 64 * segs >= 4 * 132 and seg * (segs - 1) < 2048
    with pytest.raises(ValueError):
        segmented_wkv6_reference(*[torch.zeros(1, 16, 4)] * 4,
                                 torch.zeros(1, 4), segment=0)


def test_torch_wkv6_rejects_ragged_seq():
    inp = [torch.from_numpy(a) for a in _inputs(1, 40, 8, seed=0)]
    with pytest.raises(ValueError):
        wkv6(*inp, chunk=16)
    with pytest.raises(ValueError):
        chunked_wkv6_reference(*inp, chunk=16)


def test_torch_wkv6_wrapper_checks():
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(2, 32, 8, seed=1))
    with pytest.raises(TypeError):
        wkv6(r.double(), k, v, w, u)
    with pytest.raises(ValueError):
        wkv6(r, k.transpose(1, 2).contiguous().transpose(1, 2), v, w, u)
    with pytest.raises(ValueError):
        wkv6(r, k, v, w, u[:1])
    with pytest.raises(ValueError):
        wkv6(r, k, v, w, u, chunk=32)
    big = [torch.zeros(1, 16, 80) for _ in range(4)]
    with pytest.raises(ValueError, match="head size"):
        wkv6(*big, torch.zeros(1, 80))
    # the kernel's numerics need subnormals (csrc/wkv6.cu, "Numerics")
    assert not any("fast" in f or "ftz" in f for f in CUDA_FLAGS)


def _mixer_params(d_model, n_heads, seed):
    jp = jax_rwkv.init_rwkv6(jax.random.key(seed), d_model, n_heads)
    return jp, {k: torch.from_numpy(np.array(a)) for k, a in jp.items()}


@pytest.mark.parametrize("seq", [32, 23])
def test_torch_rwkv_mixer_chunked_matches_jax(seq, monkeypatch):
    """The time-mix forward through the chunked backend against JAX's token
    scan and JAX's chunked twin (max |d| / max |y| < 1e-4), one wrapper
    call at every length: a ragged one (23) is padded to a whole chunk
    (where JAX's twin falls back to the scan). The final state handed to
    decode is the JAX handoff's (its exact scan), at the state bar."""
    d_model, n_heads = 64, 4
    jp, tp = _mixer_params(d_model, n_heads, seed=3)
    x = (0.5 * np.random.default_rng(4).standard_normal(
        (2, seq, d_model))).astype(np.float32)
    want = [np.asarray(jax_rwkv.rwkv6_train(jp, jnp.asarray(x),
                                            n_heads=n_heads, backend=b))
            for b in ("scan", "chunked")]
    calls = []
    monkeypatch.setattr(rwkv, "wkv6",
                        lambda *a, **k: calls.append(1) or wkv6(*a, **k))
    got, s_fin = rwkv.rwkv6_train(tp, torch.from_numpy(x), n_heads=n_heads,
                                  backend="chunked", return_state=True)
    assert len(calls) == 1
    scale = float(np.max(np.abs(want[0])))
    for w_ in want:
        assert float(np.max(np.abs(got.numpy() - w_))) / scale < 1e-4
    _, s_want = jax_rwkv.rwkv6_train(jp, jnp.asarray(x), n_heads=n_heads,
                                     return_state=True)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(s_want),
                               rtol=1e-3, atol=1e-4)
