"""The port's streaming data path (``repro_torch.data.stream``) against the
JAX package's, and ``train_ctr(mode="stream")``.

The same events go through both packages' functions and must come out
bitwise equal: re-batching across event boundaries, the dropped tail,
chunk shapes, ``skip_rows``, the bounded reshuffled synthetic stream, the
``ChunkStream``'s order and cursor, and the file-tail source with its
quarantine of bad lines. The ``ChunkStream`` re-raises its worker's error
and ``close`` stops a worker blocked on a full queue. Online training on
the hotcold placement gives the same params and losses through the eager
and the scan engines, bit for bit, and a stream requires ``mode="stream"``
and the reverse.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro.data import stream as jax_stream
from repro_torch.core import build_train_step
from repro_torch.core.scaling import scale_hyperparams
from repro_torch.core.tree import flatten_with_paths
from repro_torch.data import make_ctr_dataset
from repro_torch.data import stream
from repro_torch.models import ctr
from repro_torch.train import train_ctr

VOCABS = (60, 13, 5)
KEYS = ("ids", "dense", "labels")


def _events_from(ds, sizes):
    start = 0
    for n in sizes:
        idx = np.arange(start, start + n)
        yield {"ids": ds.ids[idx], "dense": ds.dense[idx],
               "labels": ds.labels[idx]}
        start += n


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("sizes,batch", [([7, 1, 30, 0, 13, 49], 16),
                                         ([100], 32), ([3] * 33, 10)])
def test_torch_rebatch_and_chunks_match_jax(sizes, batch):
    """Rows carry over event boundaries, the sub-batch tail is dropped,
    and chunks stack ``[k, batch, ...]`` with a short last chunk: bitwise
    the reference's."""
    ds = make_ctr_dataset(sum(sizes), VOCABS, n_dense=3, seed=0)
    got = list(stream.batches_from_events(_events_from(ds, sizes), batch))
    want = list(jax_stream.batches_from_events(_events_from(ds, sizes),
                                               batch))
    _assert_items_equal(got, want)
    assert len(got) == sum(sizes) // batch
    for k in (1, 3):
        _assert_items_equal(
            list(stream.chunks_from_batches(iter(got), k)),
            list(jax_stream.chunks_from_batches(iter(want), k)))


def test_torch_rebatch_refuses_bad_arguments():
    ds = make_ctr_dataset(20, VOCABS, n_dense=3, seed=1)
    with pytest.raises(ValueError, match="drop_remainder"):
        list(stream.batches_from_events(_events_from(ds, [20]), 16,
                                        drop_remainder=False))
    with pytest.raises(ValueError, match="batch_size"):
        list(stream.batches_from_events(_events_from(ds, [20]), 0))
    with pytest.raises(ValueError, match="scan_steps"):
        list(stream.chunks_from_batches(iter([]), 0))


@pytest.mark.parametrize("skip", [0, 5, 7, 40, 100])
def test_torch_skip_rows_matches_jax(skip):
    ds = make_ctr_dataset(60, VOCABS, n_dense=3, seed=2)
    sizes = [7, 13, 20, 20]
    _assert_items_equal(
        list(stream.skip_rows(_events_from(ds, sizes), skip)),
        list(jax_stream.skip_rows(_events_from(ds, sizes), skip)))
    # the batches after a skip depend on the rows only
    got = np.concatenate([e["labels"] for e in stream.skip_rows(
        _events_from(ds, sizes), skip)] or [np.zeros(0, np.float32)])
    np.testing.assert_array_equal(got, ds.labels[skip:])


def test_torch_synthetic_event_stream_matches_jax():
    ds = make_ctr_dataset(40, VOCABS, n_dense=3, seed=7)
    got = list(stream.synthetic_event_stream(ds, events=5, rows_per_event=16,
                                             seed=0))
    _assert_items_equal(got, list(jax_stream.synthetic_event_stream(
        ds, events=5, rows_per_event=16, seed=0)))
    assert len(got) == 5
    first_pass = np.concatenate([e["labels"] for e in got[:3]])
    np.testing.assert_array_equal(np.sort(first_pass), np.sort(ds.labels))


def test_torch_chunk_stream_matches_jax_and_keeps_order():
    ds = make_ctr_dataset(128, VOCABS, n_dense=3, seed=4)
    with stream.stream_chunks(_events_from(ds, [50, 50, 28]), 16, 2,
                              buffer_size=2, start_rows=32) as cs:
        got = list(cs)
        cursor = cs.cursor()
    with jax_stream.stream_chunks(_events_from(ds, [50, 50, 28]), 16, 2,
                                  buffer_size=2, start_rows=32) as cs:
        want = list(cs)
        assert cursor == cs.cursor()
    _assert_items_equal(got, want)
    assert [c["labels"].shape[0] for c in got] == [2, 2, 2, 2]
    np.testing.assert_array_equal(
        np.concatenate([c["labels"].reshape(-1) for c in got]),
        ds.labels[:128])
    assert cursor == {"start_rows": 32, "rows_staged": 128,
                      "batch_size": 16, "scan_steps": 2}


def test_torch_chunk_stream_reraises_worker_error():
    ds = make_ctr_dataset(64, VOCABS, n_dense=3, seed=5)

    def bad_events():
        yield from _events_from(ds, [32])
        raise RuntimeError("source fell over")

    with pytest.raises(RuntimeError, match="source fell over"):
        list(stream.ChunkStream(bad_events(), 16, 1))


def test_torch_chunk_stream_close_stops_blocked_worker():
    ds = make_ctr_dataset(64, VOCABS, n_dense=3, seed=6)
    closed = threading.Event()

    def endless():
        try:
            while True:
                yield {"ids": ds.ids[:8], "dense": ds.dense[:8],
                       "labels": ds.labels[:8]}
        finally:
            closed.set()

    cs = stream.ChunkStream(endless(), 8, 1, buffer_size=1)
    next(iter(cs))               # the worker is now blocked on the queue
    cs.close()
    cs._worker.join(timeout=5.0)
    assert not cs._worker.is_alive()
    assert closed.wait(timeout=1.0)
    cs.close()                   # idempotent


def test_torch_chunk_stream_transform_ends_stream():
    ds = make_ctr_dataset(64, VOCABS, n_dense=3, seed=8)
    seen = []

    def transform(chunk):
        seen.append(chunk["labels"].shape)
        return None if len(seen) > 2 else chunk

    got = list(stream.ChunkStream(_events_from(ds, [64]), 8, 1,
                                  transform=transform))
    assert len(got) == 2 and len(seen) == 3


def test_torch_follow_tsv_roundtrip_with_quarantine(tmp_path):
    """Rows written while the tail follows arrive as the reference's
    follower reads them; malformed lines go to the quarantine file,
    counted in the cursor, in both packages alike."""
    ds = make_ctr_dataset(48, VOCABS, n_dense=3, seed=8)
    path = str(tmp_path / "events.tsv")
    open(path, "w").close()

    def produce():
        stream.write_tsv_rows(path, ds, 0, 20)
        with open(path, "a") as f:
            f.write("1\t0.5\n")                      # too few fields
            f.write("\t".join(["1", "x", "0", "0", "1", "2", "3"]) + "\n")
            f.write("\t".join(["0", "0", "0", "0", "99", "2", "3"]) + "\n")
        time.sleep(0.05)
        stream.write_tsv_rows(path, ds, 20, 48)

    t = threading.Thread(target=produce)
    t.start()
    cursor = {}
    got = list(stream.follow_tsv_events(path, VOCABS, 3, rows_per_event=16,
                                        idle_timeout_s=0.5, cursor=cursor))
    t.join()
    assert sum(len(e["labels"]) for e in got) == 48
    np.testing.assert_array_equal(np.concatenate([e["ids"] for e in got]),
                                  ds.ids)
    np.testing.assert_allclose(np.concatenate([e["dense"] for e in got]),
                               ds.dense, atol=1e-6, rtol=0)
    assert cursor["rows_quarantined"] == 3 and cursor["rows_emitted"] == 48
    with open(path + ".quarantine") as f:
        assert len(f.read().splitlines()) == 3
    # the reference's follower reads the same file into the same events
    j_cursor = {}
    want = list(jax_stream.follow_tsv_events(
        path, VOCABS, 3, rows_per_event=16, idle_timeout_s=0.2,
        cursor=j_cursor, quarantine_path=str(tmp_path / "q2")))
    _assert_items_equal(got, want)
    assert cursor == j_cursor


def _run_stream(engine, max_steps=12):
    cfg = ctr.CTRConfig(name="deepfm", vocab_sizes=VOCABS, n_dense=3,
                        emb_dim=8, mlp_dims=(16, 16, 16), emb_sigma=1e-2,
                        placement="hotcold")
    hp = scale_hyperparams("cowclip", base_lr=1e-3, base_l2=1e-3,
                           base_batch=32, batch_size=32, base_dense_lr=2e-3)
    ds = make_ctr_dataset(600, VOCABS, n_dense=3, zipf_a=1.2, seed=9)
    tr, te = ds.split(0.8)
    bundle = build_train_step(cfg, hp, hot_capacity=16)
    source = stream.stream_chunks(
        stream.synthetic_event_stream(tr, events=40, rows_per_event=48,
                                      seed=1), 32, 4)
    res = train_ctr(cfg, None, tr, te, batch_size=32, seed=0,
                    step_bundle=bundle, engine=engine, mode="stream",
                    stream=source, max_steps=max_steps, device="cpu")
    return res, flatten_with_paths(bundle.export(res.params))


def test_torch_stream_training_eager_scan_agree():
    """The same event stream through the eager and the scan engines (a
    chunk of 4 cut to 2 at the budget): identical step counts, losses and
    final params, bit for bit."""
    res_e, leaves_e = _run_stream("eager", max_steps=10)
    res_s, leaves_s = _run_stream("scan", max_steps=10)
    assert res_e.steps == res_s.steps == 10
    assert res_e.losses == res_s.losses and len(res_e.losses) == 10
    assert len(res_e.step_seconds) == len(res_s.step_seconds) == 10
    assert np.isfinite(res_e.final_eval["logloss"])
    assert 0.0 <= res_e.final_eval["auc"] <= 1.0
    for k in leaves_e:
        assert torch.equal(leaves_e[k], leaves_s[k]), k


def test_torch_stream_mode_needs_a_stream():
    cfg = ctr.CTRConfig(name="deepfm", vocab_sizes=VOCABS, n_dense=3,
                        emb_dim=8, mlp_dims=(16, 16, 16))
    with pytest.raises(ValueError, match="requires a chunk stream"):
        train_ctr(cfg, None, None, None, batch_size=32, mode="stream",
                  device="cpu")
    with pytest.raises(ValueError, match="requires mode='stream'"):
        train_ctr(cfg, None, None, None, batch_size=32, stream=iter([]),
                  device="cpu")
