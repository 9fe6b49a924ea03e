"""The port's training engine (``repro_torch.train.engine``,
``repro_torch.data.prefetch``) against the JAX package's.

On the CPU the scan engine runs a chunk's steps in turn, through the same
step bodies the eager engine calls: it must equal the eager engine bit for
bit (params, optimizer state, losses), and JAX's ``lax.scan`` engine
within 1e-5, from the same params over the same ``chunk_epoch`` chunks,
which must equal JAX's bit for bit. The prefetcher's contract is the
reference's (``tests/test_engine.py``): order, error propagation, early
close. On the card the same runner captures a chunk as one CUDA graph
(``tests/test_torch_cuda.py``).
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_train_step as jax_build_train_step
from repro.core import scale_hyperparams as jax_scale_hyperparams
from repro.data import prefetch as jax_prefetch
from repro.models import ctr as jax_ctr
from repro.train import engine as jax_engine
from repro_torch.core.scaling import scale_hyperparams
from repro_torch.core.tree import flatten_with_paths, tree_map
from repro_torch.data import iterate_batches, make_ctr_dataset
from repro_torch.data import prefetch as prefetch_lib
from repro_torch.embed import store_for
from repro_torch.models import ctr
from repro_torch.train import engine as engine_lib
from repro_torch.train import train_ctr
from repro_torch.train.checkpoint import params_from_numpy, params_to_numpy

VOCABS = (300, 1000, 50)
BATCH = 256
WARMUP = 2
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def dataset():
    return make_ctr_dataset(BATCH * 11 + 100, VOCABS, n_dense=4,
                            zipf_a=1.15, seed=0)


def _common(placement):
    return dict(name="deepfm", vocab_sizes=VOCABS, n_dense=4, emb_dim=8,
                mlp_dims=(32, 32, 32), emb_sigma=1e-2,
                sparse=placement == "sparse")


def _cfg(placement):
    return dataclasses.replace(ctr.CTRConfig(**_common(placement)),
                               placement=placement)


def _hp(mod):
    return mod("cowclip", base_lr=1e-3, base_l2=1e-4, base_batch=128,
               batch_size=BATCH, base_dense_lr=2e-3)


def _clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, tree)


def _assert_equal(a, b, what):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert fa.keys() == fb.keys(), what
    for k in fa:
        assert torch.equal(torch.as_tensor(fa[k]), torch.as_tensor(fb[k])), \
            f"{what}: {k}"


# ---------------------------------------------------------------------------
# chunk_epoch and the prefetcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3, 8])
def test_torch_chunk_epoch_equals_jax(dataset, k):
    """The port's chunks are JAX's bit for bit (the tail chunk included),
    and unstacked they are ``iterate_batches``'s batches in order."""
    ours = list(prefetch_lib.chunk_epoch(dataset, BATCH, k, seed=11))
    theirs = list(jax_prefetch.chunk_epoch(dataset, BATCH, k, seed=11))
    n_batches = len(dataset) // BATCH
    assert [c["labels"].shape[0] for c in ours] == \
        [c["labels"].shape[0] for c in theirs]
    assert sum(c["labels"].shape[0] for c in ours) == n_batches
    if n_batches % k:
        assert ours[-1]["labels"].shape[0] == n_batches % k
    for a, b in zip(ours, theirs):
        for key in ("ids", "dense", "labels"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    flat = list(iterate_batches(dataset, BATCH, seed=11))
    i = 0
    for c in ours:
        for j in range(c["labels"].shape[0]):
            for key in ("ids", "dense", "labels"):
                np.testing.assert_array_equal(c[key][j], flat[i][key])
            i += 1
    assert i == len(flat)


def test_torch_chunk_epoch_rejects_keep_remainder(dataset):
    for mod in (prefetch_lib, jax_prefetch):
        with pytest.raises(ValueError, match="drop_remainder"):
            list(mod.chunk_epoch(dataset, BATCH, 4, drop_remainder=False))
    with pytest.raises(ValueError, match="scan_steps"):
        list(prefetch_lib.chunk_epoch(dataset, BATCH, 0))


def test_torch_prefetch_orders_and_propagates_errors():
    assert list(prefetch_lib.prefetch(iter(range(20)))) == list(range(20))

    def boom():
        yield 1
        raise RuntimeError("worker failed")

    with pytest.raises(RuntimeError, match="worker failed"):
        list(prefetch_lib.prefetch(boom()))


def test_torch_prefetch_early_close_stops_worker():
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    it = prefetch_lib.prefetch(gen(), buffer_size=2)
    assert next(it) == 0
    it.close()
    time.sleep(0.3)
    n = len(produced)
    time.sleep(0.2)
    assert len(produced) == n    # worker stopped, not still draining


def test_torch_prefetch_chunks_on_the_cpu_are_host_chunks(dataset):
    """Without a card the chunks come back as the host arrays of
    ``chunk_epoch``."""
    got = list(prefetch_lib.prefetch_chunks(dataset, BATCH, 3, seed=2))
    want = list(prefetch_lib.chunk_epoch(dataset, BATCH, 3, seed=2))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])


# ---------------------------------------------------------------------------
# scan engine == eager engine, and == JAX's scan engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("placement", ["fused", "sparse"])
@pytest.mark.parametrize("max_steps", [None, 7])
def test_torch_train_ctr_scan_equals_eager(dataset, placement, max_steps):
    """The whole train_ctr loop over 2 epochs of 10 batches at scan_steps 4
    (a tail chunk of 2 each epoch) and with a max_steps cut inside a
    chunk: the scan engine's params, state, losses and eval equal the
    eager engine's bit for bit."""
    tr, te = dataset.split(0.9)
    cfg = _cfg(placement)
    hp = _hp(scale_hyperparams)
    params0 = ctr.init(cfg, seed=4, device="cpu")
    results = {}
    for eng in ("eager", "scan"):
        bundle = store_for(cfg).make_bundle(cfg, hp, warmup_steps=WARMUP)
        params = _clone(params0)
        results[eng] = train_ctr(
            cfg, None, tr, te, batch_size=BATCH, epochs=2, seed=0,
            step_bundle=bundle, max_steps=max_steps, engine=eng,
            scan_steps=4, init_state=(params, bundle.init(params)))
    a, b = results["eager"], results["scan"]
    want = max_steps or 2 * (len(tr) // BATCH)
    assert a.steps == b.steps == want
    assert len(b.losses) == len(b.step_seconds) == want
    assert a.losses == b.losses
    _assert_equal(a.params, b.params, "params")
    _assert_equal(a.opt_state, b.opt_state, "opt_state")
    assert a.final_eval["auc"] == b.final_eval["auc"]


@pytest.mark.parametrize("placement", ["fused", "sparse"])
def test_torch_chunk_runner_matches_jax(dataset, placement):
    """One chunk of 3 steps through the port's runner and through JAX's
    ``make_chunk_runner`` (jnp references, no Pallas), from the same params
    over the same chunk: params and per-step losses within 1e-5."""
    common = _common(placement)
    cfg_j = jax_ctr.CTRConfig(**common)
    cfg_t = _cfg(placement)
    bundle_j = jax_build_train_step(cfg_j, _hp(jax_scale_hyperparams),
                                    path=placement, warmup_steps=WARMUP,
                                    use_kernel=False)
    bundle_t = store_for(cfg_t).make_bundle(cfg_t, _hp(scale_hyperparams),
                                            warmup_steps=WARMUP)
    params_j = jax_ctr.init(jax.random.key(5), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    chunk = next(prefetch_lib.chunk_epoch(dataset, BATCH, 3, seed=1))

    runner_j = jax_engine.make_chunk_runner(bundle_j.scan_step)
    params_j, state_j, aux_j = runner_j(
        params_j, bundle_j.init(params_j),
        {k: jnp.asarray(v) for k, v in chunk.items()})
    params_j, _ = bundle_j.flush(params_j, state_j)
    runner_t = engine_lib.make_chunk_runner(
        engine_lib.resolve_scan_step(bundle_t))
    params_t, state_t, aux_t = runner_t(params_t, bundle_t.init(params_t),
                                        chunk)
    params_t, _ = bundle_t.flush(params_t, state_t)

    assert aux_t["loss"].shape == (3,)
    np.testing.assert_allclose(aux_t["loss"].numpy(),
                               np.asarray(aux_j["loss"]), **TOL)
    assert int(state_t["step"]) == int(state_j["step"]) == 3
    flat_t = flatten_with_paths(params_to_numpy(params_t))
    flat_j = flatten_with_paths(jax.tree.map(np.asarray, params_j))
    assert flat_t.keys() == flat_j.keys()
    for k in flat_j:
        np.testing.assert_allclose(flat_t[k], flat_j[k], err_msg=k, **TOL)


def test_torch_train_ctr_rejects_unknown_engine(dataset):
    tr, _ = dataset.split(0.9)
    cfg = _cfg("fused")
    with pytest.raises(ValueError, match="unknown engine"):
        train_ctr(cfg, None, tr, None, batch_size=BATCH,
                  step_bundle=store_for(cfg).make_bundle(
                      cfg, _hp(scale_hyperparams)),
                  engine="warp", device="cpu")


def test_torch_resolve_scan_step_prefers_the_bundle_body():
    cfg = _cfg("fused")
    bundle = store_for(cfg).make_bundle(cfg, _hp(scale_hyperparams))
    assert engine_lib.resolve_scan_step(bundle) is bundle.step.scan_step
    assert engine_lib.ENGINES == jax_engine.ENGINES
