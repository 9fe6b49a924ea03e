"""The port's CTR serving (``repro_torch.serve``: engine, micro-batcher,
hot-id cache) against the JAX package's (``tests/test_serve_ctr.py``).

Params are drawn by JAX and carried to the port through
``train/checkpoint.py``'s numpy layout; requests are the same NumPy rows on
both sides. Scores are held to the JAX engine's (and to the forward) within
1e-5, as the reference holds its own; the engine captures (on the CPU:
traces) its forward once, whatever the request sizes. On the card the
same ``TracedFn`` replays one CUDA graph (``chip_smoke.py``).
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.models import ctr as jax_ctr
from repro.serve import HotEmbeddingCache as JaxHotEmbeddingCache
from repro.serve import ServingEngine as JaxServingEngine
from repro.serve import id_frequencies as jax_id_frequencies
from repro.train.loop import make_eval_fn as jax_make_eval_fn
from repro_torch.core.scaling import scale_hyperparams
from repro_torch.core.tree import tree_leaves
from repro_torch.data import iterate_batches, make_ctr_dataset
from repro_torch.data.synthetic import CTRDataset
from repro_torch.embed import store_for
from repro_torch.embed.store import max_pending_depth, serving_snapshot
from repro_torch.models import ctr
from repro_torch.serve import (HotEmbeddingCache, MicroBatcher, ServingEngine,
                               id_frequencies)
from repro_torch.serve.engine import (TracedFn, collapse_pending_decay,
                                      make_logits_fn, padded_score_loop)
from repro_torch.train.checkpoint import params_from_numpy, params_to_numpy
from repro_torch.train.loop import make_eval_fn

VOCABS = (60, 13, 5)
COMMON = dict(name="deepfm", vocab_sizes=VOCABS, n_dense=3, emb_dim=8,
              mlp_dims=(16, 16), emb_sigma=1e-2)
ATOL = 1e-5


def _rows(n, seed=0, vocabs=VOCABS, n_dense=3):
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, v, n) for v in vocabs], 1).astype(np.int32)
    dense = rng.normal(size=(n, n_dense)).astype(np.float32)
    return ids, dense


def _apply(params, cfg, ids, dense):
    with torch.inference_mode():
        return ctr.apply(params, cfg, torch.as_tensor(ids),
                         torch.as_tensor(dense)).numpy()


@pytest.fixture(scope="module")
def model():
    """(port cfg, port params, JAX cfg, JAX params): the same values."""
    cfg_j = jax_ctr.CTRConfig(**COMMON)
    params_j = jax_ctr.init(jax.random.key(0), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return ctr.CTRConfig(**COMMON), params_t, cfg_j, params_j


# ---------------------------------------------------------------------------
# engine: the JAX engine's scores, one capture
# ---------------------------------------------------------------------------


def test_torch_engine_scores_match_jax_across_sizes_one_trace(model):
    cfg, params, cfg_j, params_j = model
    ids, dense = _rows(300)
    ref = _apply(params, cfg, ids, dense)
    eng = ServingEngine(cfg, params, batch_size=64)
    eng_j = JaxServingEngine(cfg_j, params_j, batch_size=64)
    for n in (1, 3, 64, 65, 200, 300):
        got = eng.score(ids[:n], dense[:n])
        assert got.dtype == np.float32 and got.shape == (n,)
        np.testing.assert_allclose(got, ref[:n], atol=ATOL)
        np.testing.assert_allclose(got, eng_j.score(ids[:n], dense[:n]),
                                   atol=ATOL)
    assert eng.n_traces == eng_j.n_traces == 1
    s = eng.stats()
    assert s["rows"] == 1 + 3 + 64 + 65 + 200 + 300
    assert s["n_traces"] == 1 and s["batch_size"] == 64


def test_torch_engine_scores_single_row_1d_input(model):
    cfg, params, cfg_j, params_j = model
    ids, dense = _rows(1)
    one = ServingEngine(cfg, params, batch_size=16).score(ids[0], dense[0])
    np.testing.assert_allclose(one, _apply(params, cfg, ids, dense),
                               atol=ATOL)
    np.testing.assert_allclose(
        one, JaxServingEngine(cfg_j, params_j, batch_size=16).score(
            ids[0], dense[0]), atol=ATOL)


def test_torch_padded_score_loop_tail_roundtrip(model):
    cfg, params, cfg_j, params_j = model
    ids, dense = _rows(130)
    ref = np.asarray(jax_ctr.apply(params_j, cfg_j, ids, dense))
    for bs in (130, 64, 7):                  # exact, tail, tiny slices
        logits_fn = make_logits_fn(cfg)
        got = padded_score_loop(logits_fn, params, ids, dense, bs)
        np.testing.assert_allclose(got, ref, atol=ATOL)
        assert logits_fn.n_traces == 1


def test_torch_engine_bf16_compute_dtype(model):
    """bf16 scoring: finite f32 logits within bf16 resolution of the f32
    forward (the reference's bar, 0.1) and of the JAX engine's bf16
    scores (1e-2: both round to bf16 at the same cast points, and differ
    in their accumulation order only)."""
    cfg, params, cfg_j, params_j = model
    ids, dense = _rows(64)
    ref = _apply(params, cfg, ids, dense)
    eng = ServingEngine(cfg, params, batch_size=64, compute_dtype="bfloat16")
    s = eng.score(ids, dense)
    assert s.dtype == np.float32 and np.isfinite(s).all()
    assert np.abs(s - ref).max() < 0.1
    assert eng.cfg.compute_dtype == "bfloat16"
    s_j = JaxServingEngine(cfg_j, params_j, batch_size=64,
                           compute_dtype="bfloat16").score(ids, dense)
    assert np.abs(s - s_j).max() < 1e-2


def test_torch_traced_fn_counts_signatures():
    calls = []

    def body(x, y):
        calls.append(1)
        return x + y

    fn = TracedFn(body)
    a = np.ones((4, 2), np.float32)
    for _ in range(3):
        fn(a, a)
    assert fn.n_traces == 1
    fn(np.ones((5, 2), np.float32), np.ones((5, 2), np.float32))
    assert fn.n_traces == 2 and len(calls) == 4


# ---------------------------------------------------------------------------
# eval: one capture across test-set sizes
# ---------------------------------------------------------------------------


def test_torch_make_eval_fn_single_trace_across_test_sizes(model):
    cfg, params, cfg_j, params_j = model
    evaluate = make_eval_fn(cfg)
    evaluate_j = jax_make_eval_fn(cfg_j)
    for n in (10, 33, 64, 100):              # all smaller than batch_size
        ids, dense = _rows(n, seed=n)
        labels = (np.random.default_rng(n).random(n) < 0.4).astype(np.float32)
        ds = CTRDataset(ids, dense, labels, VOCABS)
        m = evaluate(params, ds, batch_size=128)
        m_j = evaluate_j(params_j, ds, batch_size=128)
        assert np.isfinite(m["logloss"]) and 0.0 <= m["auc"] <= 1.0
        for key in ("auc", "logloss"):
            assert abs(m[key] - m_j[key]) <= ATOL, key
    assert evaluate.logits_fn.n_traces == 1


def test_torch_make_eval_fn_metrics_unchanged_by_padding(model):
    cfg, params, _, _ = model
    n = 90
    ids, dense = _rows(n, seed=3)
    labels = (np.random.default_rng(3).random(n) < 0.3).astype(np.float32)
    ds = CTRDataset(ids, dense, labels, VOCABS)
    m_pad = make_eval_fn(cfg)(params, ds, batch_size=128)
    m_exact = make_eval_fn(cfg)(params, ds, batch_size=45)
    assert m_pad["auc"] == pytest.approx(m_exact["auc"], abs=1e-6)
    assert m_pad["logloss"] == pytest.approx(m_exact["logloss"], abs=1e-6)


# ---------------------------------------------------------------------------
# micro-batcher (the reference's cases, on the port's engine)
# ---------------------------------------------------------------------------


def test_torch_batcher_roundtrip_matches_jax(model):
    cfg, params, cfg_j, params_j = model
    ids, dense = _rows(120)
    ref = np.asarray(jax_ctr.apply(params_j, cfg_j, ids, dense))
    eng = ServingEngine(cfg, params, batch_size=32)
    with MicroBatcher(eng.score, max_batch=32, max_wait_ms=1.0) as mb:
        futs = [(i, mb.submit(ids[i:i + 5], dense[i:i + 5]))
                for i in range(0, 120, 5)]
        for i, f in futs:
            np.testing.assert_allclose(f.result(timeout=10), ref[i:i + 5],
                                       atol=ATOL)
    assert eng.n_traces == 1


def test_torch_batcher_coalesces_under_concurrency(model):
    cfg, params, _, _ = model
    ids, dense = _rows(256)
    eng = ServingEngine(cfg, params, batch_size=64)
    eng.score(ids[:1], dense[:1])            # the capture, before the clock
    with MicroBatcher(eng.score, max_batch=64, max_wait_ms=20.0) as mb:
        barrier = threading.Barrier(16)

        def client(k):
            barrier.wait()
            mb.score(ids[4 * k: 4 * k + 4], dense[4 * k: 4 * k + 4])

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        s = mb.stats()
    assert s["requests"] == 16
    assert s["dispatches"] < 16
    assert s["rows"] == 64
    assert s["mean_fill"] > 4


def test_torch_batcher_deadline_flushes_partial_batch(model):
    cfg, params, _, _ = model
    ids, dense = _rows(2)
    eng = ServingEngine(cfg, params, batch_size=64)
    eng.score(ids, dense)
    with MicroBatcher(eng.score, max_batch=64, max_wait_ms=5.0) as mb:
        t0 = time.perf_counter()
        mb.score(ids, dense)                 # alone: only the deadline flushes
        waited = time.perf_counter() - t0
        s = mb.stats()
    assert s["deadline_dispatches"] == 1 and s["full_dispatches"] == 0
    assert waited < 2.0


def test_torch_batcher_never_splits_a_request():
    ids, dense = _rows(30)
    calls = []

    def spy_score(i, d):
        calls.append(i.shape[0])
        return np.zeros(i.shape[0], np.float32)

    with MicroBatcher(spy_score, max_batch=16, max_wait_ms=50.0) as mb:
        f1 = mb.submit(ids[:10], dense[:10])
        f2 = mb.submit(ids[10:19], dense[10:19])
        assert f1.result(timeout=10).shape == (10,)
        assert f2.result(timeout=10).shape == (9,)
    assert calls == [10, 9]


def test_torch_batcher_error_propagates_and_batcher_survives(model):
    cfg, params, _, _ = model
    ids, dense = _rows(4)
    eng = ServingEngine(cfg, params, batch_size=16)
    boom = {"on": True}

    def flaky(i, d):
        if boom["on"]:
            raise RuntimeError("scorer exploded")
        return eng.score(i, d)

    with MicroBatcher(flaky, max_batch=16, max_wait_ms=1.0) as mb:
        f = mb.submit(ids, dense)
        with pytest.raises(RuntimeError, match="scorer exploded"):
            f.result(timeout=10)
        boom["on"] = False
        assert mb.score(ids, dense).shape == (4,)
        assert mb.stats()["errors"] == 1


def test_torch_batcher_stress_no_future_lost_or_duplicated():
    """Many threads submit under injected scorer faults: every future
    resolves exactly once, to its own rows (an echo scorer), failures
    fail only their own callers, and the accounting conserves."""
    n_threads, per_thread = 24, 20
    fail_every = 7
    dispatch_no = [0]
    lock = threading.Lock()

    def echo_score(ids, dense):
        with lock:
            dispatch_no[0] += 1
            k = dispatch_no[0]
        if k % fail_every == 0:
            raise RuntimeError(f"injected fault {k}")
        return ids[:, 0].astype(np.float32)

    results = [[None] * per_thread for _ in range(n_threads)]
    with MicroBatcher(echo_score, max_batch=32, max_wait_ms=1.0,
                      max_pending=64) as mb:
        barrier = threading.Barrier(n_threads)

        def client(t):
            rng = np.random.default_rng(t)
            barrier.wait()
            futs = []
            for j in range(per_thread):
                n = int(rng.integers(1, 6))
                ids = np.full((n, 3), t * per_thread + j, np.int32)
                futs.append((j, ids, mb.submit(ids, np.zeros((n, 3)))))
            for j, ids, f in futs:
                try:
                    results[t][j] = ("ok", f.result(timeout=30), ids)
                except RuntimeError as e:
                    results[t][j] = ("err", str(e), ids)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        s = mb.stats()

    ok = failed = 0
    for t in range(n_threads):
        for j in range(per_thread):
            assert results[t][j] is not None, (t, j)
            kind, val, ids = results[t][j]
            if kind == "ok":
                ok += 1
                np.testing.assert_array_equal(
                    val, ids[:, 0].astype(np.float32))
            else:
                failed += 1
                assert "injected fault" in val
    assert ok + failed == n_threads * per_thread
    assert s["requests"] == n_threads * per_thread
    assert s["errors"] == dispatch_no[0] // fail_every
    assert failed > 0 and ok > 0


def test_torch_batcher_deadline_opens_at_pickup_not_submit():
    shapes = []
    release = threading.Event()

    def gated_score(ids, dense):
        shapes.append(ids.shape[0])
        if len(shapes) == 1:
            release.wait(timeout=10)
        return np.zeros(ids.shape[0], np.float32)

    ids, dense = _rows(4)
    with MicroBatcher(gated_score, max_batch=16, max_wait_ms=2.0) as mb:
        f1 = mb.submit(ids[:1], dense[:1])
        time.sleep(0.05)
        f2 = mb.submit(ids[1:2], dense[1:2])
        time.sleep(0.05)
        f3 = mb.submit(ids[2:4], dense[2:4])
        release.set()
        for f in (f1, f2, f3):
            f.result(timeout=10)
        s = mb.stats()
    assert shapes == [1, 3]
    assert s["dispatches"] == 2


def test_torch_batcher_rejects_bad_requests():
    ids, dense = _rows(40)
    with MicroBatcher(lambda i, d: np.zeros(i.shape[0], np.float32),
                      max_batch=16) as mb:
        with pytest.raises(ValueError, match="exceeds max_batch"):
            mb.submit(ids[:20], dense[:20])
        with pytest.raises(ValueError, match="rows"):
            mb.submit(ids[:3], dense[:4])
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(ids[:1], dense[:1])


# ---------------------------------------------------------------------------
# placement snapshots and the hot cache
# ---------------------------------------------------------------------------


def _trained_snapshot(path, params0, n_steps=5):
    """``n_steps`` of the port's ``path`` bundle from ``params0``; returns
    (cfg, snapshot, pending depth before the flush, train ids)."""
    cfg = ctr.CTRConfig(**COMMON, placement=path)
    ds = make_ctr_dataset(640, VOCABS, n_dense=3, zipf_a=1.2, seed=11)
    hp = scale_hyperparams("cowclip", base_lr=1e-2, base_l2=1e-2,
                           base_batch=64, batch_size=64)
    bundle = store_for(cfg).make_bundle(cfg, hp)
    params = bundle.prepare(
        params_from_numpy(params_to_numpy(params0), "cpu"))
    state = bundle.init(params)
    for i, b in enumerate(iterate_batches(ds, 64, seed=2)):
        batch = {k: torch.as_tensor(v) for k, v in b.items()}
        params, state, _ = bundle.step(params, state, batch)
        if i + 1 >= n_steps:
            break
    depth = max_pending_depth(state)
    return cfg, serving_snapshot(bundle, params, state), depth, ds.ids


@pytest.mark.parametrize("path", ["fused", "sparse"])
def test_torch_hot_cache_exact_for_every_placement(model, path):
    """Cached scores equal the uncached forward, the port's engine and the
    JAX engine and hot cache on the same snapshot (1e-5); the sparse
    placement arrives with pending decay, so the snapshot went through the
    closed-form catch-up."""
    cfg, params0, cfg_j, _ = model
    cfg, snap, depth, train_ids = _trained_snapshot(path, params0)
    assert (depth > 0) if path == "sparse" else (depth == 0)
    ids, dense = _rows(150, seed=7)
    ref = _apply(snap, cfg, ids, dense)
    snap_j = jax.tree.map(np.asarray, params_to_numpy(snap))

    eng = ServingEngine(cfg, snap, batch_size=64)
    np.testing.assert_allclose(eng.score(ids, dense), ref, atol=ATOL)
    want = JaxServingEngine(cfg_j, snap_j, batch_size=64).score(ids, dense)
    np.testing.assert_allclose(eng.score(ids, dense), want, atol=ATOL)

    freqs = id_frequencies(train_ids, cfg.vocab_sizes)
    for capacity in (4, 10_000):             # partial and all-hot admission
        cache = HotEmbeddingCache(cfg, snap, freqs, capacity=capacity,
                                  batch_size=64, device="cpu")
        got = cache.score(ids, dense)
        np.testing.assert_allclose(got, ref, atol=ATOL)
        cache_j = JaxHotEmbeddingCache(cfg_j, snap_j, freqs,
                                       capacity=capacity, batch_size=64)
        np.testing.assert_allclose(got, cache_j.score(ids, dense),
                                   atol=ATOL)
        assert cache.n_traces == 1


def test_torch_serving_snapshot_collapses_pending_decay(model):
    """The sparse snapshot equals the raw tables after the closed-form
    catch-up, ``collapse_pending_decay``."""
    cfg = ctr.CTRConfig(**COMMON, placement="sparse")
    ds = make_ctr_dataset(640, VOCABS, n_dense=3, zipf_a=1.2, seed=11)
    hp = scale_hyperparams("cowclip", base_lr=1e-2, base_l2=1e-2,
                           base_batch=64, batch_size=64)
    bundle = store_for(cfg).make_bundle(cfg, hp)
    params = bundle.prepare(
        params_from_numpy(params_to_numpy(model[1]), "cpu"))
    state = bundle.init(params)
    for i, b in enumerate(iterate_batches(ds, 64, seed=2)):
        params, state, _ = bundle.step(
            params, state, {k: torch.as_tensor(v) for k, v in b.items()})
        if i + 1 >= 5:
            break
    assert max_pending_depth(state) > 0
    manual = collapse_pending_decay(
        params["embed"], state["last_step"], state["step"],
        lr=hp.emb_lr, l2=hp.emb_l2)
    snap = serving_snapshot(bundle, params, state)
    for a, b_ in zip(tree_leaves(snap["embed"]), tree_leaves(manual)):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-6)


def test_torch_id_frequencies_equal_jax():
    ids, _ = _rows(500, seed=5)
    freqs = id_frequencies(ids, VOCABS)
    want = jax_id_frequencies(ids, VOCABS)
    for i, v in enumerate(VOCABS):
        assert freqs[f"field_{i}"].shape == (v,)
        assert freqs[f"field_{i}"].sum() == 500
        np.testing.assert_array_equal(freqs[f"field_{i}"],
                                      want[f"field_{i}"])


def test_torch_hot_cache_hit_rate_tracks_admission(model):
    cfg, params, cfg_j, params_j = model
    rng = np.random.default_rng(9)
    ids = np.stack([np.minimum(rng.zipf(1.5, 400) - 1, v - 1)
                    for v in VOCABS], 1).astype(np.int32)
    dense = rng.normal(size=(400, 3)).astype(np.float32)
    freqs = id_frequencies(ids, VOCABS)

    full = HotEmbeddingCache(cfg, params, freqs, capacity=10_000,
                             batch_size=64, device="cpu")
    full.score(ids, dense)
    assert full.hit_rate() == 1.0

    tiny = HotEmbeddingCache(cfg, params, freqs, capacity=2, batch_size=64,
                             device="cpu")
    tiny.score(ids, dense)
    assert 0.5 < tiny.hit_rate() < 1.0
    assert tiny.stats()["device_rows"] == 2 * len(VOCABS)
    tiny_j = JaxHotEmbeddingCache(cfg_j, params_j, freqs, capacity=2,
                                  batch_size=64)
    tiny_j.score(ids, dense)
    assert tiny.hit_rate() == tiny_j.hit_rate()


def test_torch_hot_cache_rejects_mismatched_freqs(model):
    cfg, params, _, _ = model
    freqs = {f"field_{i}": np.ones(v + 1) for i, v in enumerate(VOCABS)}
    with pytest.raises(ValueError, match="freq length"):
        HotEmbeddingCache(cfg, params, freqs, device="cpu")


def test_torch_hot_cache_behind_batcher(model):
    cfg, params, cfg_j, params_j = model
    ids, dense = _rows(80)
    ref = np.asarray(jax_ctr.apply(params_j, cfg_j, ids, dense))
    freqs = id_frequencies(ids, VOCABS)
    cache = HotEmbeddingCache(cfg, params, freqs, capacity=8, batch_size=32,
                              device="cpu")
    with MicroBatcher(cache.score, max_batch=32, max_wait_ms=1.0) as mb:
        futs = [mb.submit(ids[i:i + 4], dense[i:i + 4])
                for i in range(0, 80, 4)]
        for k, f in enumerate(futs):
            np.testing.assert_allclose(f.result(timeout=10),
                                       ref[4 * k: 4 * k + 4], atol=ATOL)
    assert cache.n_traces == 1
