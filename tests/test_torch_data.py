"""The port's NumPy data path, metrics and scaling rules against the JAX
package's: the same seed must give identical arrays, the pinned FNV-1a
hash values must hold, and AUC / hyperparameters must be equal."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.scaling as jax_scaling
import repro.data as jax_data
import repro.train.metrics as jax_metrics
import repro_torch.core.scaling as scaling
import repro_torch.data as data
from repro_torch.data.criteo import _hash_token, hash_tokens
from repro_torch.train import metrics

VOCABS = (100, 1000, 37)


@pytest.mark.parametrize("seed,n_dense,zipf_a", [(0, 4, 1.2), (7, 13, 1.1)])
def test_torch_make_ctr_dataset_identical(seed, n_dense, zipf_a):
    a = data.make_ctr_dataset(3000, VOCABS, n_dense=n_dense, zipf_a=zipf_a,
                              seed=seed)
    b = jax_data.make_ctr_dataset(3000, VOCABS, n_dense=n_dense,
                                  zipf_a=zipf_a, seed=seed)
    for field in ("ids", "dense", "labels"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y, err_msg=field)
    assert a.vocab_sizes == b.vocab_sizes


@pytest.mark.parametrize("shuffle,drop_remainder", [
    (True, True), (False, False), (True, False)])
def test_torch_iterate_batches_identical(shuffle, drop_remainder):
    ds = data.make_ctr_dataset(1000, VOCABS, seed=3)
    ds_j = jax_data.make_ctr_dataset(1000, VOCABS, seed=3)
    tr, _ = ds.split(0.9)
    tr_j, _ = ds_j.split(0.9)
    ours = list(data.iterate_batches(tr, 128, seed=5, shuffle=shuffle,
                                     drop_remainder=drop_remainder))
    ref = list(jax_data.iterate_batches(tr_j, 128, seed=5, shuffle=shuffle,
                                        drop_remainder=drop_remainder))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        for k in ("ids", "dense", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


def test_torch_criteo_hash_pinned_and_vectorized():
    """The FNV-1a values pinned in tests/test_data.py hold in the port's
    copy, and its vectorized column hash agrees with the scalar one."""
    assert _hash_token(0, "deadbeef", 100_000) == 60471
    assert _hash_token(3, "<missing>", 100_000) == 77462
    assert _hash_token(25, "0004c67c", 100_000) == 12249
    rng = np.random.default_rng(7)
    toks = [f"{rng.integers(0, 16**8):08x}" for _ in range(300)]
    toks += ["<missing>", "", "a", "deadbeef", "0" * 16]
    for field in (0, 11, 25):
        vec = hash_tokens(field, toks, 997)
        np.testing.assert_array_equal(
            vec, [_hash_token(field, t, 997) for t in toks])


def test_torch_criteo_loader_identical(tmp_path):
    rng = np.random.default_rng(0)
    rows = []
    for _ in range(40):
        ints = [str(rng.integers(0, 100)) if rng.random() > 0.2 else ""
                for _ in range(13)]
        cats = [f"{rng.integers(0, 16**8):08x}" if rng.random() > 0.1 else ""
                for _ in range(26)]
        rows.append("\t".join([str(rng.integers(0, 2))] + ints + cats))
    p = tmp_path / "criteo.tsv"
    p.write_text("\n".join(rows) + "\n")
    a = data.load_criteo_tsv(str(p), vocab_per_field=1000)
    b = jax_data.load_criteo_tsv(str(p), vocab_per_field=1000)
    for field in ("ids", "dense", "labels"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("ties", [False, True])
def test_torch_auc_numpy_equal(ties):
    rng = np.random.default_rng(11)
    scores = rng.standard_normal(2000)
    if ties:
        scores = np.round(scores, 1)
    labels = (rng.random(2000) < 0.3).astype(np.float32)
    assert metrics.auc_numpy(scores, labels) == jax_metrics.auc_numpy(
        scores, labels)


def test_torch_logloss_matches():
    """Mean BCE from logits, large logits included (no softplus cutoff)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    logits = (rng.standard_normal(512) * 12).astype(np.float32)
    labels = (rng.random(512) < 0.25).astype(np.float32)
    ours = float(metrics.logloss(torch.from_numpy(logits),
                                 torch.from_numpy(labels)))
    ref = float(jax_metrics.logloss(jnp.asarray(logits), jnp.asarray(labels)))
    assert ours == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("rule", jax_scaling.RULES)
@pytest.mark.parametrize("batch", [1024, 8192, 131072])
def test_torch_scale_hyperparams_equal(rule, batch):
    kw = dict(base_lr=1e-4, base_l2=1e-5, base_batch=1024, batch_size=batch,
              base_dense_lr=2e-4)
    assert scaling.RULES == jax_scaling.RULES
    ours = dataclasses.asdict(scaling.scale_hyperparams(rule, **kw))
    ref = dataclasses.asdict(jax_scaling.scale_hyperparams(rule, **kw))
    assert ours == ref


def test_torch_prefetch_order_and_errors():
    from repro_torch.data.prefetch import prefetch

    assert list(prefetch(iter(range(10)), buffer_size=2)) == list(range(10))

    def boom():
        yield 1
        raise RuntimeError("worker failed")

    with pytest.raises(RuntimeError, match="worker failed"):
        list(prefetch(boom()))
