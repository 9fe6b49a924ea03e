"""The port's fused CowClip + coupled-L2 + Adam update against the JAX
package's: the Pallas kernel (interpret mode on the CPU, as
tests/test_kernels.py runs it) and its jnp reference.

On the CPU ``repro_torch.kernels.cowclip.fused_cowclip_adam`` runs its plain
PyTorch version; the CUDA kernel is held to that plain version on the card
by tests/test_torch_cuda.py and chip_smoke.py. Inputs come from NumPy
with a seed and go to both frameworks unchanged.
"""

try:
    import hypothesis
    import hypothesis.strategies as st
except ImportError:  # fall back to deterministic parametrized sweeps
    from hypcompat import hypothesis, st
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.optim import decay_factor as jax_decay_factor
from repro.kernels.cowclip import fused_cowclip_adam as jax_fused
from repro.kernels.cowclip import reference as jax_reference
from repro_torch.core.optim import decay_factor
from repro_torch.kernels.cowclip import (fused_cowclip_adam, reference,
                                         step_scalars)


def _inputs(vocab, dim, seed=0, cnt_mode="random"):
    rng = np.random.default_rng(seed)
    w = (0.01 * rng.standard_normal((vocab, dim))).astype(np.float32)
    g = (0.1 * rng.standard_normal((vocab, dim))).astype(np.float32)
    if cnt_mode == "zero":
        cnt = np.zeros((vocab,), np.float32)
    else:
        cnt = rng.integers(0, 4, (vocab,)).astype(np.float32)
    m = (0.01 * rng.standard_normal((vocab, dim))).astype(np.float32)
    v = (0.001 * np.abs(rng.standard_normal((vocab, dim)))).astype(np.float32)
    return w, g, cnt, m, v


def _torch_update(arrays, step, **kw):
    """Port's wrapper on CPU tensors; returns numpy (w, m, v)."""
    w, g, cnt, m, v = (torch.from_numpy(a.copy()) for a in arrays)
    out = fused_cowclip_adam(w, g, cnt, m, v, step_scalars(step), **kw)
    return [t.numpy() for t in out]


def _jax(fn, arrays, step, **kw):
    out = fn(*(jnp.asarray(a) for a in arrays), jnp.asarray(step, jnp.int32),
             **kw)
    return [np.asarray(t) for t in out]


@pytest.mark.parametrize("vocab,dim,cnt_mode", [
    (64, 8, "random"), (1000, 10, "random"), (512, 128, "random"),
    (2048, 256, "random"), (777, 48, "random"), (8, 4096, "random"),
    (1000, 1, "random"), (300, 10, "zero"), (300, 1, "zero"),
])
def test_torch_cowclip_shape_sweep(vocab, dim, cnt_mode):
    """rtol 1e-5 / atol 1e-7: the JAX kernel's own bar against its
    reference (tests/test_kernels.py), held here against both."""
    arrays = _inputs(vocab, dim, seed=vocab + dim, cnt_mode=cnt_mode)
    kw = dict(r=1.0, zeta=1e-5, lr=1e-4, l2=1e-5)
    out_t = _torch_update(arrays, 3, **kw)
    for name, fn in (("pallas", jax_fused), ("reference", jax_reference)):
        out_j = _jax(fn, arrays, 3, **kw)
        for a, b, leaf in zip(out_t, out_j, ("w", "m", "v")):
            np.testing.assert_allclose(
                a, b, rtol=1e-5, atol=1e-7,
                err_msg=f"{leaf} vs JAX {name} vocab={vocab} dim={dim}")


@hypothesis.given(
    step=st.integers(1, 10_000),
    r=st.floats(0.1, 10.0),
    zeta=st.sampled_from([1e-5, 1e-4, 1e-3]),
    seed=st.integers(0, 50),
)
@hypothesis.settings(max_examples=25, deadline=None, database=None)
def test_torch_cowclip_hyperparam_property(step, r, zeta, seed):
    """rtol 1e-4 / atol 1e-6 over random steps and clip hypers, as
    test_cowclip_kernel_hyperparam_property holds the JAX kernel."""
    arrays = _inputs(128, 8, seed=seed)
    kw = dict(r=r, zeta=zeta, lr=1e-3, l2=1e-4)
    out_t = _torch_update(arrays, step, **kw)
    out_j = _jax(jax_fused, arrays, step, **kw)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("lr,l2", [
    (1e-4, 1e-5), (2e-2, 1e-5 * 32), (8e-2, 1e-5 * 512), (1e-3, 0.0),
    (0.1, 0.3), (3e-4, 7e-6),
])
def test_torch_decay_factor_bitmatches(lr, l2):
    """Every path shares this f32 rounding: it must equal the reference's
    bit for bit, not just within a tolerance."""
    a, b = decay_factor(lr, l2), jax_decay_factor(lr, l2)
    assert np.float32(a).tobytes() == np.float32(b).tobytes()
    assert a == float(np.float32(a))


def test_torch_cowclip_in_place_and_no_launch_on_cpu():
    """The wrapper writes w, m, v in place on the CPU too, returns the same
    tensors, and counts no kernel launch (the plain version ran)."""
    arrays = _inputs(50, 6, seed=1)
    w, g, cnt, m, v = (torch.from_numpy(a.copy()) for a in arrays)
    before = fused_cowclip_adam.launches
    out = fused_cowclip_adam(w, g, cnt, m, v, step_scalars(2))
    assert out[0] is w and out[1] is m and out[2] is v
    assert fused_cowclip_adam.launches == before
    ref = reference(*(torch.from_numpy(a) for a in arrays), step_scalars(2))
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    # absent rows: w scaled by the decay factor, moments held
    absent = arrays[2] == 0
    np.testing.assert_array_equal(m.numpy()[absent], arrays[3][absent])
    np.testing.assert_array_equal(
        w.numpy()[absent],
        arrays[0][absent] * np.float32(decay_factor(1e-4, 1e-5)))


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "shape", "cnt_shape",
                                 "step", "step_int"])
def test_torch_cowclip_wrapper_rejects_bad_inputs(bad):
    """Bad tables, a step of 0, and a bare int where the step's block goes
    (the wrappers take a ``StepScalars`` only)."""
    w, g, cnt, m, v = (torch.from_numpy(a.copy())
                       for a in _inputs(16, 4, seed=2))
    step = lambda: step_scalars(1)  # noqa: E731
    if bad == "dtype":
        g = g.double()
    elif bad == "contiguous":
        m = torch.from_numpy(np.ascontiguousarray(m.numpy().T)).T
    elif bad == "shape":
        v = v[:8]
    elif bad == "cnt_shape":
        cnt = cnt[:, None]
    elif bad == "step":
        step = lambda: step_scalars(0)  # noqa: E731
    else:
        step = lambda: 1  # noqa: E731
    with pytest.raises((TypeError, ValueError)):
        fused_cowclip_adam(w, g, cnt, m, v, step())
