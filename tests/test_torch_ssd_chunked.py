"""The chunk form of the port's Mamba-2 scan
(``repro_torch.kernels.ssd.ssd_scan_chunked_reference``) on the CPU.

It is the forward kernel's decomposition written in plain PyTorch
(``csrc/ssd_scan.cu``: log-space in-chunk cumsums, the masked C B^T, its
product with dt x, C s_in^T, the chunk's own state and the carry, with
the state entering each chunk kept). It is held to the reference's scan,
``jax.lax.scan`` over ``repro.models.mamba._ssm_step`` through
``tests/test_torch_ssd.py``'s harness, at the LM bar (1e-4), and to the
op's token loop (``ssd_scan_reference``) at 1e-5 of the largest value for
y, the final state and the kept chunk states. Cases: one token, inside
one chunk, one whole chunk, a whole chunk and one more, a ragged last
chunk; decays that underflow to 0 (dt ~ 14: exp(-dt A) is 0 in f32 for
the heads with the larger A); dt = 0 on some tokens.

``ssd_scan_backward_chunked_reference``, the backward kernel's chunk form
(the reverse carry of the state's cotangent, the masked C B^T and gy x^T
products, the log decay's gradient as four sums with no difference of
large terms), is held to ``jax.grad`` of the reference's scan at the LM
bar (scaled by the largest value where that is above 1) and to the
written-out reverse recurrence (``ssd_scan_backward_reference``) at 1e-5
of each gradient's largest value, with both cotangents, one of them
absent (zero, as the op passes it) and decays that underflow to 0.

Both kernels are held to both plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 51).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd import (n_chunks,
                                     ssd_scan_backward_chunked_reference,
                                     ssd_scan_backward_reference,
                                     ssd_scan_chunked_reference,
                                     ssd_scan_reference)
from test_torch_ssd import (LM_BAR, NAMES, _inputs, _jax_fwd, _jax_grads,
                            _max_abs, _torch)

PLAIN_BAR = 1e-5    # over the largest |value|: two f32 orders of one sum

CASES = [
    pytest.param(1, -2.0, None, id="S1"),
    pytest.param(5, -2.0, None, id="S5"),
    pytest.param(16, -2.0, None, id="S16-whole"),
    pytest.param(17, -2.0, None, id="S17"),
    pytest.param(70, -2.0, None, id="S70-ragged"),
    pytest.param(17, 14.0, None, id="S17-large-dt"),
    pytest.param(70, 14.0, None, id="S70-large-dt"),
    pytest.param(16, -2.0, 3, id="S16-dt-zero"),
    pytest.param(70, -2.0, 2, id="S70-dt-zero"),
]


def _rel(got, want):
    """max |got - want| over max |want| (0 where both are all zero)."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    return err / scale if scale else err


@pytest.mark.parametrize("seq,dt_shift,zero_every", CASES)
def test_torch_ssd_chunked_matches_jax_and_token_loop(seq, dt_shift,
                                                      zero_every):
    ins, _, _ = _inputs(seq, seed=100 + seq, dt_shift=dt_shift)
    if zero_every:
        ins[3][:, ::zero_every] = 0.0
    if dt_shift > 0:     # the later heads' decays underflow to 0 in f32
        decay = np.exp(-ins[3] * np.exp(ins[4]))
        assert decay.dtype == np.float32 and (decay == 0).any()
    y, s_fin, kept = ssd_scan_chunked_reference(*_torch(ins))
    b, _, h, p = ins[0].shape
    n = ins[1].shape[-1]
    assert tuple(y.shape) == (b, seq, h, p)
    assert tuple(s_fin.shape) == (b, h, p, n)
    assert tuple(kept.shape) == (b, h, n_chunks(seq), p, n)
    assert all(bool(torch.isfinite(t).all()) for t in (y, s_fin, kept))

    want_y, want_s = _jax_fwd(*ins)
    assert _max_abs(want_y, y) <= LM_BAR
    assert _max_abs(want_s, s_fin) <= LM_BAR

    want = ssd_scan_reference(*_torch(ins), chunk_states=True)
    for got, ref in zip((y, s_fin, kept), want):
        assert _rel(got, ref) <= PLAIN_BAR
    assert not kept[:, :, 0].any()      # the zero state entering chunk 0


BACKWARD_CASES = [
    pytest.param(1, -2.0, "both", id="S1"),
    pytest.param(5, -2.0, "both", id="S5"),
    pytest.param(16, -2.0, "both", id="S16-whole"),
    pytest.param(17, -2.0, "both", id="S17"),
    pytest.param(64, -2.0, "both", id="S64"),
    pytest.param(70, -2.0, "both", id="S70-ragged"),
    pytest.param(33, -2.0, "y", id="S33-no-state-cotangent"),
    pytest.param(17, -2.0, "state", id="S17-no-y-cotangent"),
    pytest.param(17, 14.0, "both", id="S17-large-dt"),
    pytest.param(70, 14.0, "both", id="S70-large-dt"),
]


@pytest.mark.parametrize("seq,dt_shift,cot", BACKWARD_CASES)
def test_torch_ssd_backward_chunked_matches_jax_and_written_out(seq,
                                                                dt_shift,
                                                                cot):
    ins, gy, gs = _inputs(seq, seed=200 + seq, dt_shift=dt_shift)
    if cot == "y":
        gs = np.zeros_like(gs)
    elif cot == "state":
        gy = np.zeros_like(gy)
    if dt_shift > 0:
        decay = np.exp(-ins[3] * np.exp(ins[4]))
        assert (decay == 0).mean() > 0.5
    args = _torch(ins)
    kept = ssd_scan_reference(*args, chunk_states=True)[2]
    cots = [torch.from_numpy(gy), torch.from_numpy(gs)]
    got = ssd_scan_backward_chunked_reference(*args, kept, *cots)
    assert [tuple(g.shape) for g in got] == [t.shape for t in ins]
    assert all(bool(torch.isfinite(g).all()) for g in got)

    want = _jax_grads(ins, gy, gs)
    for name, w, g in zip(NAMES, want, got):
        bar = LM_BAR * max(1.0, float(np.max(np.abs(np.asarray(w)))))
        assert _max_abs(w, g) <= bar, (name, _max_abs(w, g))

    plain = ssd_scan_backward_reference(*args, kept, *cots)
    for name, w, g in zip(NAMES, plain, got):
        assert (g - w).abs().max().item() <= \
            PLAIN_BAR * w.abs().max().item(), (name, _rel(g, w))
