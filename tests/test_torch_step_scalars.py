"""Step scalars on the device, and the non-finite guard.

The port's step counters are 0-dim int32 tensors on the params' device,
and the scalars a step derives from them (the bias corrections, the
warmup's learning rate, the CowClip kernels' step block) are computed
there: a captured CUDA graph would freeze a host value at its capture.
On the CPU these must equal the host arithmetic they replace bit for bit.
``nonfinite_guard`` is a device select with the JAX package's semantics:
a NaN/Inf loss skips the whole update, a finite one changes nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scale_hyperparams as jax_scale_hyperparams
from repro.data import iterate_batches as jax_iterate_batches
from repro.embed import store_for as jax_store_for
from repro.models import ctr as jax_ctr
from repro_torch.core import builders, optim
from repro_torch.core.scaling import scale_hyperparams
from repro_torch.core.tree import flatten_with_paths, tree_map
from repro_torch.data import iterate_batches, make_ctr_dataset
from repro_torch.data.prefetch import chunk_epoch
from repro_torch.embed import store_for
from repro_torch.kernels.cowclip import (StepScalars, fused_cowclip_adam,
                                         reference, step_scalars)
from repro_torch.kernels.cowclip.cowclip import bias_corrections
from repro_torch.models import ctr
from repro_torch.train import engine as engine_lib
from repro_torch.train.checkpoint import params_from_numpy, params_to_numpy

VOCABS = (400, 90, 7)
BATCH = 128
TOL = dict(rtol=1e-5, atol=1e-5)


def _bits(x) -> int:
    return int(np.float32(x).view(np.int32))


def test_torch_device_bias_corrections_equal_host_rounding():
    """``core.optim.bias_corrections`` of a 0-dim int32 counter, and of a
    vector of them (where the CPU's vectorized pow would round differently
    for some t), equals the host's ``bias_corrections(t)`` bit for bit,
    t = 1 .. 20000, and the step block carries those bits."""
    for b1, b2 in ((0.9, 0.999), (0.8, 0.99)):
        for t in range(1, 20001):
            got = optim.bias_corrections(torch.tensor(t, dtype=torch.int32),
                                         b1, b2)
            want = bias_corrections(t, b1, b2)
            assert [_bits(g) for g in got] == [_bits(w) for w in want], t
        steps = torch.arange(1, 20001, dtype=torch.int32)
        vec = [c.view(torch.int32).tolist()
               for c in optim.bias_corrections(steps, b1, b2)]
        for t in range(1, 20001):
            want = bias_corrections(t, b1, b2)
            assert [vec[0][t - 1], vec[1][t - 1]] == [
                _bits(w) for w in want], t
    for t in (1, 2, 17, 1000, 19999):
        words = step_scalars(torch.tensor(t, dtype=torch.int32)).words
        want = bias_corrections(t, 0.9, 0.999)
        assert words.tolist() == [t, _bits(want[0]), _bits(want[1]), 1]


def _host_count_dense_tx(hp, warmup_steps, b1=0.9, b2=0.999, eps=1e-8):
    """The dense tower's chain as it was before the counters moved to the
    device: Python-int counts, scalars as 0-dim f32 CPU tensors. The
    oracle of the device-counter chain."""
    f32 = optim.f32

    def init(params):
        zeros = tree_map(torch.zeros_like, params)
        return (0, zeros, tree_map(torch.zeros_like, params), 0)

    def update(grads, state, params):
        count, mu, nu, sched = state
        if hp.dense_l2:
            grads = tree_map(lambda g, w: g + hp.dense_l2 * w, grads, params)
        count += 1
        mu = tree_map(lambda m, g: b1 * m + (1.0 - b1) * g, mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1.0 - b2) * torch.square(g),
                      nu, grads)
        c = f32(count)
        mh, nh = 1.0 / (1.0 - b1 ** c), 1.0 / (1.0 - b2 ** c)
        ups = tree_map(lambda m, v: (m * mh) / (torch.sqrt(v * nh) + eps),
                       mu, nu)
        frac = torch.clamp_max((f32(sched) + 1.0) / warmup_steps, 1.0)
        step_size = -(hp.dense_lr * frac)
        ups = tree_map(lambda g: step_size * g, ups)
        return ups, (count, mu, nu, sched + 1)

    return init, update


@pytest.mark.parametrize("dense_l2", [0.0, 1e-4])
def test_torch_dense_adam_device_counters_equal_host_counts(dense_l2):
    """50 steps of the dense chain with a warmup of 20: the device-counter
    chain's updates and moments equal the host-count chain's bit for
    bit; its counters are 0-dim int32 tensors that count the steps."""
    hp = dataclasses.replace(
        scale_hyperparams("cowclip", base_lr=1e-3, base_l2=1e-5,
                          base_batch=128, batch_size=1024,
                          base_dense_lr=2e-3), dense_l2=dense_l2)
    tx = builders.dense_tower_tx(hp, warmup_steps=20)
    init_h, update_h = _host_count_dense_tx(hp, 20)
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(7, 5, generator=gen),
              "b": torch.randn(5, generator=gen)}
    state, state_h = tx.init(params), init_h(params)
    for _ in range(50):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen),
                         params)
        ups, state = tx.update(grads, state, params)
        ups_h, state_h = update_h(grads, state_h, params)
        for k in params:
            assert torch.equal(ups[k], ups_h[k]), k
        params = optim.apply_updates(params, ups)
    adam = next(s for s in state if isinstance(s, optim.ScaleByAdamState))
    sched = next(s for s in state
                 if isinstance(s, optim.ScaleByScheduleState))
    for counter in (adam.count, sched.count):
        assert counter.dtype == torch.int32 and counter.dim() == 0
        assert int(counter) == 50
    for k in params:
        assert torch.equal(adam.mu[k], state_h[1][k])
        assert torch.equal(adam.nu[k], state_h[2][k])


def test_torch_step_block_guard_flag_reaches_the_plain_versions():
    """A guarded block whose flag is 0 leaves a table as it was; 1 gives
    the unguarded update bit for bit."""
    gen = torch.Generator().manual_seed(1)
    w, g, m, v = (torch.randn(50, 6, generator=gen) for _ in range(4))
    v = v.abs()
    cnt = (torch.rand(50, generator=gen) < 0.5).to(torch.float32)
    t = torch.tensor(3, dtype=torch.int32)
    plain = reference(w, g, cnt, m, v, step_scalars(3))
    for flag in (False, True):
        block = step_scalars(t, ok=torch.tensor(flag))
        assert isinstance(block, StepScalars) and block.guarded
        got = reference(w, g, cnt, m, v, block)
        for a, b, old in zip(got, plain, (w, m, v)):
            assert torch.equal(a, b if flag else old)
    tables = [x.clone() for x in (w, m, v)]
    fused_cowclip_adam(tables[0], g, cnt, tables[1], tables[2],
                       step_scalars(t, ok=torch.tensor(False)))
    assert all(torch.equal(a, b) for a, b in zip(tables, (w, m, v)))


# ---------------------------------------------------------------------------
# the guard, against JAX's where-select
# ---------------------------------------------------------------------------


def _setup(placement):
    common = dict(name="deepfm", vocab_sizes=VOCABS, n_dense=4, emb_dim=6,
                  mlp_dims=(16, 16), emb_sigma=1e-2)
    hkw = dict(base_lr=1e-2, base_l2=1e-3, base_batch=64, batch_size=BATCH,
               base_dense_lr=2e-3)
    cfg_j = jax_ctr.CTRConfig(**common, sparse=placement == "sparse")
    cfg_t = ctr.CTRConfig(**common, placement=placement)
    ds = make_ctr_dataset(6 * BATCH, VOCABS, n_dense=4, zipf_a=1.2, seed=3)
    return (cfg_j, cfg_t, jax_scale_hyperparams("cowclip", **hkw),
            scale_hyperparams("cowclip", **hkw), ds)


def _poison(batch):
    bad = dict(batch, dense=batch["dense"].copy())
    bad["dense"][0, 0] = np.nan
    return bad


@pytest.mark.parametrize("placement", ["fused", "sparse"])
def test_torch_nonfinite_guard_matches_jax(placement):
    """Clean, NaN, clean, clean batches through the guarded steps of both
    packages from the same params: the NaN step is skipped on both
    (skipped_steps 1, the step counter held), and params, moments, step
    and (sparse) last_step agree to 1e-5 after every step."""
    cfg_j, cfg_t, hp_j, hp_t, ds = _setup(placement)
    bundle_j = jax_store_for(cfg_j, path=placement).make_bundle(
        cfg_j, hp_j, warmup_steps=2, use_kernel=False, nonfinite_guard=True)
    bundle_t = store_for(cfg_t).make_bundle(cfg_t, hp_t, warmup_steps=2,
                                            nonfinite_guard=True)
    params_j = jax_ctr.init(jax.random.key(2), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    state_j, state_t = bundle_j.init(params_j), bundle_t.init(params_t)
    batches = list(iterate_batches(ds, BATCH, seed=0))[:4]
    assert len(batches) == 4 and list(jax_iterate_batches(
        ds, BATCH, seed=0))[0]["ids"].tolist() == batches[0]["ids"].tolist()
    batches[1] = _poison(batches[1])
    for i, b in enumerate(batches):
        params_j, state_j, aux_j = bundle_j.step(
            params_j, state_j, {k: jnp.asarray(v) for k, v in b.items()})
        params_t, state_t, aux_t = bundle_t.step(
            params_t, state_t, {k: torch.from_numpy(v) for k, v in b.items()})
        assert int(aux_t["skipped_steps"]) == int(aux_j["skipped_steps"]) \
            == (i == 1)
        assert aux_t["skipped_steps"].dtype == torch.int32
        assert int(state_t["step"]) == int(state_j["step"]) == i + (i < 1)
        flat_t = flatten_with_paths(params_to_numpy(
            {"params": params_t, "m": state_t["m"], "v": state_t["v"]}))
        flat_j = flatten_with_paths(jax.tree.map(np.asarray, {
            "params": params_j, "m": state_j["m"], "v": state_j["v"]}))
        for k in flat_j:
            np.testing.assert_allclose(flat_t[k], flat_j[k],
                                       err_msg=f"step {i}: {k}", **TOL)
        if placement == "sparse":
            for k, ls in flatten_with_paths(state_t["last_step"]).items():
                np.testing.assert_array_equal(
                    ls.numpy(),
                    np.asarray(flatten_with_paths(state_j["last_step"])[k]))


@pytest.mark.parametrize("placement", ["fused", "sparse", "hotcold"])
def test_torch_nonfinite_guard_is_exact_on_clean_data(placement):
    """Over 4 clean batches the guarded step equals the unguarded one bit
    for bit (params and the whole state); a NaN batch leaves every leaf
    of the params and the state bitwise as it was."""
    _, cfg, _, hp, ds = _setup(placement)
    plain = store_for(cfg).make_bundle(cfg, hp, warmup_steps=2)
    guarded = store_for(cfg).make_bundle(cfg, hp, warmup_steps=2,
                                         nonfinite_guard=True)
    params0 = ctr.init(cfg, seed=1, device="cpu")
    runs = []
    for bundle in (plain, guarded):
        p = tree_map(torch.clone, params0)
        s = bundle.init(p)
        for b in list(iterate_batches(ds, BATCH, seed=1))[:4]:
            p, s, _ = bundle.step(
                p, s, {k: torch.from_numpy(v) for k, v in b.items()})
        runs.append(flatten_with_paths({"p": p, "s": s}))
    assert runs[0].keys() == runs[1].keys()
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k

    p = tree_map(torch.clone, params0)
    s = guarded.init(p)
    b = next(iterate_batches(ds, BATCH, seed=1))
    p, s, _ = guarded.step(p, s, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
    before = {k: v.clone() for k, v in flatten_with_paths(
        {"p": p, "s": s}).items()}
    p, s, aux = guarded.step(p, s, {k: torch.from_numpy(v) for k, v in
                                    _poison(b).items()})
    assert int(aux["skipped_steps"]) == 1
    after = flatten_with_paths({"p": p, "s": s})
    for k in before:
        assert torch.equal(before[k], after[k]), k


@pytest.mark.parametrize("placement", ["fused", "sparse", "hotcold"])
def test_torch_guarded_chunk_equals_guarded_eager_steps(placement):
    """A chunk of 4 batches, the second poisoned, through the scan
    engine's runner equals the same guarded steps one by one, bit for
    bit; the chunk's skipped_steps sum to 1."""
    _, cfg, _, hp, ds = _setup(placement)
    bundle = store_for(cfg).make_bundle(cfg, hp, warmup_steps=2,
                                        nonfinite_guard=True)
    chunk = next(chunk_epoch(ds, BATCH, 4, seed=5))
    chunk["dense"][1, 0, 0] = np.nan
    params0 = ctr.init(cfg, seed=3, device="cpu")

    p = tree_map(torch.clone, params0)
    s = bundle.init(p)
    losses = []
    for i in range(4):
        p, s, aux = bundle.step(
            p, s, {k: torch.from_numpy(v[i]) for k, v in chunk.items()})
        losses.append(aux["loss"])
    eager = flatten_with_paths({"p": p, "s": s})

    p = tree_map(torch.clone, params0)
    s = bundle.init(p)
    runner = engine_lib.make_chunk_runner(engine_lib.resolve_scan_step(bundle))
    p, s, aux = runner(p, s, chunk)
    assert int(aux["skipped_steps"].sum()) == 1
    assert int(s["step"]) == 3
    want = torch.stack(losses)
    assert bool(torch.isnan(aux["loss"][1])) and bool(torch.isnan(want[1]))
    assert torch.equal(aux["loss"][[0, 2, 3]], want[[0, 2, 3]])
    scan = flatten_with_paths({"p": p, "s": s})
    for k in eager:
        assert torch.equal(eager[k], scan[k]), k
