"""The port's Mamba-2 scan op (``repro_torch.kernels.ssd``) on the CPU.

``ssd_scan`` (the op's plain token loop), its gradient (the written-out
reverse recurrence, ``ssd_scan_backward_reference``) and autograd of the
plain loop against the reference's scan, ``jax.lax.scan`` over
``repro.models.mamba._ssm_step`` as ``mamba2_train`` runs it, and
``jax.grad`` of it, at the LM bar (1e-4) for S in {1, 5, 64, 70} (inside
one kept chunk, across chunks and a ragged last one). The written-out
backward against autograd of the plain loop at 1e-5 of each gradient's
largest value, also with one cotangent absent and with decays that
underflow to 0. Then the op's shape functions on fake tensors at zamba2's
full layer over 32,768 tokens, its FLOP formulas against what
``FlopCounterMode`` counts for the plain loop, its input checks, and the
dry-run of the mini zamba2 tracing one scan op a Mamba layer. Inputs are
made with numpy from a seed. The kernels themselves are held to these
plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 51).
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.models import mamba as jax_mamba
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels.ssd import (CHUNK, n_chunks, ssd_scan,
                                     ssd_scan_backward_reference,
                                     ssd_scan_reference)
from repro_torch.launch import dryrun
from test_torch_dryrun import mesh  # noqa: F401

LM_BAR = 1e-4
B, H, P, N = 2, 3, 20, 16
NAMES = ("xs", "bmat", "cmat", "dt", "a_log", "d_skip")


def _inputs(seq, seed, dt_shift=-2.0):
    """numpy (xs, bmat, cmat, dt, a_log, d_skip) and the cotangents of y
    and of the final state."""
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    dt = np.log1p(np.exp(arr(B, seq, H) + dt_shift)).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    ins = (arr(B, seq, H, P), arr(B, seq, N), arr(B, seq, N), dt, a_log,
           arr(H))
    return ins, arr(B, seq, H, P), arr(B, H, P, N)


def _jax_scan(xs, bmat, cmat, dt, a_log, d_skip):
    """The reference's scan as ``mamba2_train`` runs it."""
    s0 = jnp.zeros((xs.shape[0], xs.shape[2], xs.shape[3], bmat.shape[-1]),
                   jnp.float32)

    def body(s, inp):
        xt, bt, ct, dtt = inp
        y, s = jax_mamba._ssm_step(xt, bt, ct, dtt, a_log, d_skip, s)
        return s, y

    s_fin, ys = jax.lax.scan(body, s0, tuple(
        jnp.swapaxes(t, 0, 1) for t in (xs, bmat, cmat, dt)))
    return jnp.swapaxes(ys, 0, 1), s_fin


_jax_fwd = jax.jit(_jax_scan)


@jax.jit
def _jax_grads(ins, gy, gs):
    def loss(*args):
        y, s = _jax_scan(*args)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    return jax.grad(loss, argnums=tuple(range(6)))(*ins)


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _torch(ins):
    return [torch.from_numpy(t.copy()) for t in ins]


def _grads(fn, ins, gy, gs):
    """Gradients of ``sum(y * gy) + sum(s * gs)`` through ``fn``."""
    leaves = [t.clone().requires_grad_() for t in _torch(ins)]
    y, s = fn(*leaves)
    loss = 0.0
    if gy is not None:
        loss = loss + (y * torch.from_numpy(gy)).sum()
    if gs is not None:
        loss = loss + (s * torch.from_numpy(gs)).sum()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, grads)]


@pytest.mark.parametrize("seq", [1, 5, 64, 70])
def test_torch_ssd_scan_matches_jax(seq):
    """y, the final state and the six gradients through the op and
    through autograd of the plain loop, against JAX's scan and jax.grad
    of it: 1e-4, scaled by the largest value where that is above 1 (the
    gradients of A_log and D are sums over every token and row, of
    magnitude ~60 here, whose f32 rounding is ~1e-6 of it); the op's
    forward is the plain loop's bits."""
    ins, gy, gs = _inputs(seq, seed=seq)
    want_y, want_s = _jax_fwd(*ins)
    y, s = ssd_scan(*_torch(ins))
    assert tuple(y.shape) == (B, seq, H, P) and tuple(s.shape) == (B, H, P, N)
    assert _max_abs(want_y, y) <= LM_BAR and _max_abs(want_s, s) <= LM_BAR
    with torch.no_grad():
        plain = ssd_scan_reference(*_torch(ins))
    assert torch.equal(plain[0], y) and torch.equal(plain[1], s)
    want = _jax_grads(ins, gy, gs)
    for fn in (ssd_scan, ssd_scan_reference):
        got = _grads(fn, ins, gy, gs)
        for name, w, g in zip(NAMES, want, got):
            assert tuple(g.shape) == w.shape, name
            bar = LM_BAR * max(1.0, float(np.max(np.abs(w))))
            assert _max_abs(w, g) <= bar, (fn.__name__, name,
                                           _max_abs(w, g))


@pytest.mark.parametrize("seq,cot,dt_shift", [
    (70, "both", -2.0), (33, "y", -2.0), (17, "state", -2.0),
    (40, "both", 14.0)])
def test_torch_ssd_backward_reference_matches_autograd(seq, cot, dt_shift):
    """The written-out reverse recurrence against autograd of the plain
    loop, each gradient within 1e-5 of its largest value; one cotangent
    absent (the op counts it as zero; autograd leaves c's unused); with
    dt_shift 14 most decays (exp(-dt A), A up to 16) underflow to 0,
    where a state is never rebuilt by dividing by a_t."""
    ins, gy, gs = _inputs(seq, seed=100 + seq, dt_shift=dt_shift)
    gy = gy if cot in ("both", "y") else None
    gs = gs if cot in ("both", "state") else None
    if dt_shift > 0:
        a = np.exp(-ins[3] * np.exp(ins[4]))
        assert (a == 0).mean() > 0.5
    want = _grads(ssd_scan_reference, ins, gy, gs)
    got = _grads(ssd_scan, ins, gy, gs)
    for name, w, g in zip(NAMES, want, got):
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= 1e-5 * scale, name


def test_torch_ssd_chunk_states_and_direct_backward():
    """The chunk states the forward keeps are the plain loop's states at
    each chunk's start (zero first), and the backward reference called
    on them gives autograd's gradients."""
    seq = 2 * CHUNK + 3
    ins, gy, gs = _inputs(seq, seed=7)
    xs, bmat, cmat, dt, a_log, d_skip = _torch(ins)
    y, s_fin, kept = ssd_scan_reference(xs, bmat, cmat, dt, a_log, d_skip,
                                        chunk_states=True)
    assert tuple(kept.shape) == (B, H, n_chunks(seq), P, N) == (B, H, 3, P, N)
    assert not kept[:, :, 0].any()
    for k in (1, 2):
        _, s_k = ssd_scan_reference(xs[:, :k * CHUNK], bmat[:, :k * CHUNK],
                                    cmat[:, :k * CHUNK], dt[:, :k * CHUNK],
                                    a_log, d_skip)
        assert torch.equal(kept[:, :, k], s_k)
    got = ssd_scan_backward_reference(xs, bmat, cmat, dt, a_log, d_skip,
                                      kept, torch.from_numpy(gy),
                                      torch.from_numpy(gs))
    want = _grads(ssd_scan_reference, ins, gy, gs)
    for name, w, g in zip(NAMES, want, got):
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item(), \
            name


def test_torch_ssd_fake_shapes_at_full_width():
    """On fake tensors at zamba2's layer over 32,768 tokens ([1, 32768,
    80, 64], N 64) the op runs its shape functions alone: forward, and
    forward and backward under autograd, in under a second, with the
    real shapes (the kept states too)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    b, s, h, p, n = 1, 32768, 80, 64, 64
    t0 = time.perf_counter()
    with FakeTensorMode():
        ins = [torch.empty(b, s, h, p), torch.empty(b, s, n),
               torch.empty(b, s, n), torch.empty(b, s, h), torch.empty(h),
               torch.empty(h)]
        y, s_fin = ssd_scan(*ins)
        kept = torch.ops.repro_torch.ssd_scan_fwd(*ins, True)[2]
        leaves = [t.requires_grad_() for t in ins]
        y2, s2 = ssd_scan(*leaves)
        grads = torch.autograd.grad((y2.sum(), s2.sum()), leaves)
    assert time.perf_counter() - t0 < 1.0
    assert tuple(y.shape) == (b, s, h, p) and tuple(s_fin.shape) == (b, h, p,
                                                                     n)
    assert tuple(kept.shape) == (b, h, s // CHUNK, p, n)
    assert [tuple(g.shape) for g in grads] == [tuple(t.shape) for t in ins]


def test_torch_ssd_flop_formulas_match_the_plain_loop():
    """FlopCounterMode counts the op's forward and backward as it counts
    the plain loop under autograd (its states @ c product: 2 B S H P N
    forward, twice that backward)."""
    ins, gy, gs = _inputs(21, seed=3)
    counts = {}
    for fn in (ssd_scan, ssd_scan_reference):
        leaves = [t.requires_grad_() for t in _torch(ins)]
        with FlopCounterMode(display=False) as fc:
            y, s = fn(*leaves)
            fwd = fc.get_total_flops()
            torch.autograd.grad((y * torch.from_numpy(gy)).sum()
                                + (s * torch.from_numpy(gs)).sum(), leaves)
        counts[fn.__name__] = (fwd, fc.get_total_flops() - fwd)
    bshpn = B * 21 * H * P * N
    assert counts["ssd_scan"] == counts["ssd_scan_reference"] == (
        2 * bshpn, 4 * bshpn)


def test_torch_ssd_rejects_bad_inputs():
    """f32, contiguity, shapes, S >= 1, N <= 64 and a CPU or CUDA device,
    checked before anything runs; the CPU path launches no kernel."""
    ins = _torch(_inputs(5, seed=1)[0])
    before = (ssd_scan.launches, ssd_scan.backward_launches)
    ssd_scan(*ins)
    assert (ssd_scan.launches, ssd_scan.backward_launches) == before
    bad = [
        (0, ins[0].double(), TypeError),
        (0, ins[0].transpose(1, 2).contiguous().transpose(1, 2), ValueError),
        (1, ins[1][:, :4], ValueError),
        (3, ins[3][..., :2], ValueError),
        (4, ins[4][:2], ValueError),
    ]
    for i, t, err in bad:
        args = list(ins)
        args[i] = t
        with pytest.raises(err):
            ssd_scan(*args)
    with pytest.raises(ValueError):
        ssd_scan(ins[0][:, :0], ins[1][:, :0], ins[2][:, :0], ins[3][:, :0],
                 ins[4], ins[5])
    wide = torch.zeros(B, 5, 65)
    with pytest.raises(ValueError):
        ssd_scan(ins[0], wide, wide, *ins[3:])
    with pytest.raises(ValueError):
        ssd_scan(*[t.to("meta") for t in ins])


def test_torch_ssd_dryrun_traces_one_scan_a_mamba_layer(mesh):  # noqa: F811
    """The mini zamba2 of ``tests/test_torch_dryrun.py`` on the fake 2 x 4
    mesh: its train step (remat off) traces one ``ssd_scan_fwd`` and one
    ``ssd_scan_bwd`` a Mamba layer, its prefill one ``ssd_scan_fwd`` a
    layer and no token loop (no ``aten.bmm`` of the scan's ``states @
    c``), decode none; the ops' FLOPs and bytes are counted."""
    cfg = dataclasses.replace(reduce_config(get_config("zamba2-2.7b")),
                              d_model=256, n_heads=8, n_kv_heads=8,
                              vocab_size=512)
    layers = cfg.n_layers
    assert layers == 2
    spec = {"seq_len": 64, "global_batch": 8}
    runs = {}
    for step, shape in (("train", "train_4k"), ("prefill", "prefill_32k"),
                        ("decode", "decode_32k")):
        tr, *_ = dryrun.lower_for(cfg, shape, mesh,
                                  spec=dict(spec, step=step),
                                  force_remat=False)
        runs[step] = tr
    ops = {k: {op: tr.op_counts.get(f"repro_torch.ssd_scan_{op}", 0)
               for op in ("fwd", "bwd")} for k, tr in runs.items()}
    assert ops == {"train": {"fwd": layers, "bwd": layers},
                   "prefill": {"fwd": layers, "bwd": 0},
                   "decode": {"fwd": 0, "bwd": 0}}
    assert runs["train"].flops_by_op["repro_torch.ssd_scan_fwd"] > 0
    assert runs["train"].flops_by_op["repro_torch.ssd_scan_bwd"] == \
        2 * runs["train"].flops_by_op["repro_torch.ssd_scan_fwd"]
    assert runs["prefill"].op_counts.get("aten.bmm", 0) < 64


def test_torch_ssd_step_trace_counts_the_ops_bytes():
    """``StepTrace`` counts each scan op's operand and result bytes, as
    it counts an aten op's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.comm_analysis import StepTrace

    b, s, h, p, n = 2, 40, 4, 64, 64
    with FakeTensorMode():
        ins = [torch.empty(b, s, h, p), torch.empty(b, s, n),
               torch.empty(b, s, n), torch.empty(b, s, h), torch.empty(h),
               torch.empty(h)]
        with StepTrace() as tr:
            torch.ops.repro_torch.ssd_scan_fwd(*ins, True)
    floats = (b * s * h * p + 2 * b * s * n + b * s * h + 2 * h   # inputs
              + b * s * h * p + b * h * p * n                    # y, s_fin
              + b * h * n_chunks(s) * p * n)                     # kept
    assert tr.bytes_accessed == 4 * floats
    assert tr.op_counts == {"repro_torch.ssd_scan_fwd": 1}
