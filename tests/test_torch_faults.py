"""The port's deterministic fault injection (``repro_torch.testing.faults``)
and the defenses it exercises: ColdStore transient-I/O retry with
exponential backoff, TSV quarantine of malformed rows, the ChunkStream
worker-failure re-raise, and the non-finite step guard.

A port of ``tests/test_faults.py``. The guard's tests run on the sparse
placement, as the reference's do, and on the synchronous hot/cold one,
whose step also rewrites residency, frequencies, the hot tier and the
cold tables: there the guarded port is also held to the JAX package's
guarded hot/cold step on the same params and batches (deepfm, vocabs
(50, 40, 30), capacity 16, batch 32). The async hot/cold placement
refuses the guard with the reference's message.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.scaling import scale_hyperparams
from repro_torch.core.tree import flatten_with_paths, tree_leaves
from repro_torch.data.stream import (follow_tsv_events, stream_chunks,
                                     synthetic_event_stream, write_tsv_rows)
from repro_torch.data.synthetic import make_ctr_dataset
from repro_torch.embed.coldstore import ColdStore
from repro_torch.embed.store import EmbeddingStore, store_for
from repro_torch.models import ctr
from repro_torch.testing import (FAULT_PLAN_ENV, FaultPlan,
                                 install_coldstore_faults,
                                 transient_oserror_hook)
from repro_torch.train import train_ctr
from repro_torch.train.checkpoint import params_from_numpy

VOCABS = (60, 13, 5)
HOT_VOCABS = (50, 40, 30)      # ROADMAP section 3's input for the guard
HOT_CAPACITY = 16


def _store(vocab=16, dim=3):
    spec = {"fm": {"field_0": (vocab, dim, "float32")}}
    store = ColdStore.create(spec, backend="mem")
    store.w["fm"]["field_0"][...] = np.arange(
        vocab * dim, dtype=np.float32).reshape(vocab, dim)
    return store


# ---------------------------------------------------------------------------
# FaultPlan plumbing
# ---------------------------------------------------------------------------


def test_torch_plan_env_roundtrip(monkeypatch):
    plan = FaultPlan(kill_at_step=7, kill_in_snapshot=True,
                     io_errors={"gather": 2}, stream_raise_at_chunk=3,
                     corrupt_row_rate=0.25, seed=5)
    env = plan.to_env()
    assert FAULT_PLAN_ENV == "REPRO_FAULT_PLAN"   # the reference's name
    monkeypatch.setenv(FAULT_PLAN_ENV, env[FAULT_PLAN_ENV])
    back = FaultPlan.from_env()
    assert back.kill_at_step == 7 and back.kill_in_snapshot
    assert back.io_errors == {"gather": 2}
    assert back.stream_raise_at_chunk == 3
    assert back.corrupt_row_rate == 0.25 and back.seed == 5

    # the JAX package reads the same environment the same way
    from repro.testing import FaultPlan as JaxFaultPlan
    jax_back = JaxFaultPlan.from_env()
    assert jax_back.kill_at_step == 7 and jax_back.io_errors == {"gather": 2}

    monkeypatch.delenv(FAULT_PLAN_ENV)
    assert FaultPlan.from_env() is None


def test_torch_plan_kill_predicates(monkeypatch):
    killed = []
    monkeypatch.setattr("repro_torch.testing.faults.kill_now",
                        lambda: killed.append(True))
    plan = FaultPlan(kill_at_step=6)
    plan.maybe_kill(5)
    assert not killed
    plan.maybe_kill(6, in_snapshot=True)   # plan wants a boundary kill
    assert not killed
    plan.maybe_kill(6)
    assert killed

    killed.clear()
    snap_plan = FaultPlan(kill_at_step=6, kill_in_snapshot=True)
    snap_plan.maybe_kill(8)                # boundary: not this plan's site
    assert not killed
    snap_plan.maybe_kill(8, in_snapshot=True)
    assert killed


def test_torch_plan_io_budget_is_deterministic():
    plan = FaultPlan(io_errors={"gather": 2})
    faults = [plan.io_fault("gather") for _ in range(4)]
    assert faults == [True, True, False, False]
    assert plan.io_fault("scatter") is False

    a = FaultPlan(io_error_every=3, seed=11)
    b = FaultPlan(io_error_every=3, seed=11)
    seq_a = [a.io_fault("gather") for _ in range(50)]
    seq_b = [b.io_fault("gather") for _ in range(50)]
    assert seq_a == seq_b and any(seq_a) and not all(seq_a)

    # the same seed draws the same faults as the JAX package's plan
    from repro.testing import FaultPlan as JaxFaultPlan
    c = JaxFaultPlan(io_error_every=3, seed=11)
    assert [c.io_fault("gather") for _ in range(50)] == seq_a


def test_torch_corrupt_tsv_line_deterministic_and_malformed():
    plan = FaultPlan(corrupt_row_rate=1.0, seed=3)
    line = "1.0\t0.5\t0.5\t0.5\t10\t3\t2"
    out = plan.corrupt_tsv_line(line, n_fields=3)
    assert out != line
    plan2 = FaultPlan(corrupt_row_rate=1.0, seed=3)
    assert plan2.corrupt_tsv_line(line, n_fields=3) == out
    clean = FaultPlan(corrupt_row_rate=0.0)
    assert clean.corrupt_tsv_line(line, n_fields=3) == line


# ---------------------------------------------------------------------------
# ColdStore transient-I/O retry with backoff
# ---------------------------------------------------------------------------


def test_torch_coldstore_retries_transient_errors(tmp_path):
    """Injected OSErrors on every I/O entry point are absorbed by the
    bounded retry, counted in ``faults_retried``, and the data is right.
    ``flush_files`` only does I/O on the mmap backend, so that leg runs
    against an on-disk store."""
    store = _store()
    store.io_backoff = 1e-4
    store.fault_hook = transient_oserror_hook(
        {"gather": 2, "scatter": 1})
    got = store.gather("field_0", np.asarray([2, 5]))
    np.testing.assert_array_equal(
        got["w"]["fm"], store.w["fm"]["field_0"][[2, 5]])
    store.scatter("field_0", np.asarray([0]),
                  {"w": {"fm": np.ones((1, 3), np.float32)},
                   "m": {"fm": np.zeros((1, 3), np.float32)},
                   "v": {"fm": np.zeros((1, 3), np.float32)},
                   "ls": np.asarray([4], np.int32)})
    assert store.faults_retried == 3
    np.testing.assert_array_equal(store.w["fm"]["field_0"][0],
                                  np.ones((3,), np.float32))

    spec = {"fm": {"field_0": (8, 3, "float32")}}
    mm = ColdStore.create(spec, backend="mmap", directory=str(tmp_path))
    mm.io_backoff = 1e-4
    mm.fault_hook = transient_oserror_hook({"flush_files": 1})
    mm.flush_files()
    assert mm.faults_retried == 1
    mm.close()


def test_torch_coldstore_retry_backoff_is_exponential(monkeypatch):
    sleeps = []
    monkeypatch.setattr("repro_torch.embed.coldstore.time.sleep",
                        sleeps.append)
    store = _store()
    store.io_backoff = 0.01
    store.fault_hook = transient_oserror_hook({"gather": 3})
    store.gather("field_0", np.asarray([1]))
    assert sleeps == [0.01, 0.02, 0.04]


def test_torch_coldstore_retries_exhausted_raises():
    store = _store()
    store.io_backoff = 1e-4
    store.io_retries = 2
    store.fault_hook = transient_oserror_hook({"gather": 99})
    with pytest.raises(OSError, match="injected transient gather"):
        store.gather("field_0", np.asarray([1]))
    assert store.faults_retried == 2   # the budget, not the final raise


def test_torch_install_coldstore_faults_uses_plan():
    store = _store()
    store.io_backoff = 1e-4
    plan = FaultPlan(io_errors={"gather": 1})
    assert install_coldstore_faults(store, plan) is store
    store.gather("field_0", np.asarray([1]))
    assert store.faults_retried == 1


# ---------------------------------------------------------------------------
# TSV quarantine
# ---------------------------------------------------------------------------


def test_torch_quarantine_malformed_rows(tmp_path, caplog):
    """Corrupted rows land in the side file with one warning per shape;
    every clean row still comes through, in order."""
    ds = make_ctr_dataset(64, VOCABS, n_dense=3, seed=4)
    path = str(tmp_path / "events.tsv")
    write_tsv_rows(path, ds, 0, 32)
    with open(path) as f:
        lines = f.read().splitlines()
    bad = ["1.0\t0.5",                              # wrong field count
           "1.0\t0.5\t0.5\t0.5\tgarbage\t3\t2",     # non-integer id
           "1.0\t0.5\t0.5\t0.5\t10\t3\t2\t9",       # wrong field count
           "x\t0.5\t0.5\t0.5\t10\t3\t2",            # non-numeric label
           "1.0\t0.5\t0.5\t0.5\t10\t99\t2",         # id out of range
           "1.0\t0.5\t0.5\t0.5\t10\t99\t2"]         # same shape again
    with open(path, "w") as f:
        f.write("\n".join(lines[:16] + bad + lines[16:]) + "\n")

    cursor = {}
    with caplog.at_level(logging.WARNING,
                         logger="repro_torch.data.stream"):
        events = list(follow_tsv_events(
            path, VOCABS, 3, rows_per_event=8, idle_timeout_s=0.1,
            cursor=cursor))
    got = np.concatenate([e["labels"] for e in events])
    np.testing.assert_array_equal(got, ds.labels[:32])
    assert cursor["rows_quarantined"] == 6
    assert cursor["rows_emitted"] == 32
    with open(path + ".quarantine") as f:
        assert f.read().splitlines() == bad
    # one warning per malformation shape: nfields(2), nfields(8), int,
    # float, range — the repeated range row logs nothing new
    warnings = [r for r in caplog.records if "quarantined" in r.message]
    assert len(warnings) == 5


def test_torch_quarantine_custom_path_and_offset_resume(tmp_path):
    """The byte cursor skips quarantined rows too: resuming from
    ``cursor['offset']`` re-reads nothing."""
    ds = make_ctr_dataset(32, VOCABS, n_dense=3, seed=5)
    path = str(tmp_path / "events.tsv")
    write_tsv_rows(path, ds, 0, 16)
    with open(path, "a") as f:
        f.write("garbage line\n")
    write_tsv_rows(path, ds, 16, 32)

    qpath = str(tmp_path / "bad.rows")
    cursor = {}
    first = list(follow_tsv_events(path, VOCABS, 3, rows_per_event=16,
                                   idle_timeout_s=0.1, cursor=cursor,
                                   quarantine_path=qpath))
    assert cursor["rows_emitted"] == 32 and cursor["rows_quarantined"] == 1
    assert os.path.exists(qpath)
    np.testing.assert_array_equal(first[0]["labels"], ds.labels[:16])

    write_tsv_rows(path, ds, 0, 8)   # 8 more rows after the cursor
    cursor2 = {}
    more = list(follow_tsv_events(path, VOCABS, 3, rows_per_event=8,
                                  idle_timeout_s=0.1,
                                  start_offset=cursor["offset"],
                                  cursor=cursor2))
    assert cursor2["rows_emitted"] == 8
    np.testing.assert_array_equal(more[0]["labels"], ds.labels[:8])


# ---------------------------------------------------------------------------
# ChunkStream worker fault
# ---------------------------------------------------------------------------


def test_torch_stream_worker_fault_reraises_in_consumer():
    ds = make_ctr_dataset(512, VOCABS, n_dense=3, seed=6)

    def events():
        while True:
            yield {"ids": ds.ids[:64], "dense": ds.dense[:64],
                   "labels": ds.labels[:64]}

    plan = FaultPlan(stream_raise_at_chunk=2)
    stream = stream_chunks(events(), 32, 2,
                           transform=plan.stream_transform_hook())
    got = 0
    with pytest.raises(RuntimeError, match="injected stream-worker fault"):
        for _ in stream:
            got += 1
    assert got == 2
    stream.close()
    assert not stream._worker.is_alive()   # close joins the worker


# ---------------------------------------------------------------------------
# non-finite step guard
# ---------------------------------------------------------------------------

PLACEMENTS = {
    # placement -> (vocabs, EmbeddingStore knobs)
    "sparse": (VOCABS, {}),
    "hotcold": (HOT_VOCABS, {"hot_capacity": HOT_CAPACITY}),
    "hotcold_decayed": (HOT_VOCABS, {"hot_capacity": HOT_CAPACITY,
                                     "admission": "decayed",
                                     "half_life": 3}),
}


def _guard_setup(name="sparse"):
    vocabs, knobs = PLACEMENTS[name]
    placement = "sparse" if name == "sparse" else "hotcold"
    cfg = ctr.CTRConfig(name="deepfm", vocab_sizes=vocabs, n_dense=3,
                        emb_dim=8, mlp_dims=(16, 16, 16), emb_sigma=1e-2,
                        sparse=placement == "sparse", placement=placement)
    hp = scale_hyperparams("cowclip", base_lr=1e-3, base_l2=1e-3,
                           base_batch=32, batch_size=32, base_dense_lr=2e-3)
    return cfg, hp, store_for(cfg, **knobs), vocabs


def _batch(ds, lo, hi, poison=False):
    b = {"ids": np.asarray(ds.ids[lo:hi]),
         "dense": np.array(ds.dense[lo:hi]),
         "labels": np.asarray(ds.labels[lo:hi])}
    if poison:
        b["dense"][0, 0] = np.nan
    return b


def _tensors(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _leaves(tree):
    return {k: v.detach().clone() if isinstance(v, torch.Tensor)
            else v for k, v in flatten_with_paths(tree).items()}


def _assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        ta, tb = torch.as_tensor(a[k]), torch.as_tensor(b[k])
        assert ta.dtype == tb.dtype, k
        assert torch.equal(ta, tb), k


@pytest.mark.parametrize("name", list(PLACEMENTS))
def test_torch_nonfinite_guard_skips_poisoned_batch(name):
    """A batch with a NaN dense feature poisons the loss; the guarded
    step leaves every leaf of params and state bitwise untouched (on the
    hot/cold placement also the hot tier, the slot maps and the
    frequencies) and counts the skip. Clean batches advance exactly as
    unguarded."""
    cfg, hp, store, vocabs = _guard_setup(name)
    ds = make_ctr_dataset(160, vocabs, n_dense=3, seed=7)
    plain = store.make_bundle(cfg, hp)
    guarded = store.make_bundle(cfg, hp, nonfinite_guard=True)

    pp = plain.prepare(ctr.init(cfg, seed=0, device="cpu"))
    sp = plain.init(pp)
    pg = guarded.prepare(ctr.init(cfg, seed=0, device="cpu"))
    sg = guarded.init(pg)

    # clean steps: guarded == unguarded, bit for bit, skip counter 0
    for lo in (0, 32):
        b = _tensors(_batch(ds, lo, lo + 32))
        pp, sp, _ = plain.step(pp, sp, b)
        pg, sg, aux = guarded.step(pg, sg, b)
        assert int(aux["skipped_steps"]) == 0
        _assert_bitwise(_leaves(pp), _leaves(pg))
        _assert_bitwise(_leaves(sp), _leaves(sg))

    # poisoned step: guarded skips (params + state frozen), counts it
    before_p, before_s = _leaves(pg), _leaves(sg)
    pg, sg, aux = guarded.step(pg, sg, _tensors(_batch(ds, 64, 96, True)))
    assert int(aux["skipped_steps"]) == 1
    assert not np.isfinite(float(aux["loss"]))
    _assert_bitwise(before_p, _leaves(pg))
    _assert_bitwise(before_s, _leaves(sg))

    # training continues as the unguarded run that never saw the batch
    for lo in (96, 128):
        b = _tensors(_batch(ds, lo, lo + 32))
        pp, sp, _ = plain.step(pp, sp, b)
        pg, sg, aux = guarded.step(pg, sg, b)
        assert int(aux["skipped_steps"]) == 0
        assert np.isfinite(float(aux["loss"]))
    _assert_bitwise(_leaves(pp), _leaves(pg))
    _assert_bitwise(_leaves(sp), _leaves(sg))


@pytest.mark.parametrize("name", ["sparse", "hotcold"])
def test_torch_nonfinite_guard_scans(name):
    """The guard composes with the scan engine: a poisoned batch inside a
    chunk is skipped, the rest of the chunk applies, and the skips sum to
    the poisoned steps."""
    cfg, hp, store, vocabs = _guard_setup(name)
    ds = make_ctr_dataset(600, vocabs, n_dense=3, zipf_a=1.2, seed=9)
    tr, _ = ds.split(0.8)
    bundle = store.make_bundle(cfg, hp, nonfinite_guard=True)

    poisoned = [0]

    def events():
        for i, ev in enumerate(
                synthetic_event_stream(tr, rows_per_event=48, seed=1)):
            if i == 2:
                ev = dict(ev, dense=ev["dense"].copy())
                ev["dense"][:, 0] = np.nan
                poisoned[0] += 1
            yield ev

    stream = stream_chunks(events(), 32, 2)
    res = train_ctr(cfg, None, tr, None, batch_size=32, seed=0,
                    step_bundle=bundle, engine="scan", mode="stream",
                    stream=stream, max_steps=8, device="cpu")
    assert poisoned[0] == 1
    assert res.steps == 8
    assert int(res.opt_state["step"]) == 6   # rows 96-143 poison 2 steps
    assert sum(not np.isfinite(x) for x in res.losses) == 2
    for leaf in tree_leaves(bundle.export(res.params)):
        assert torch.isfinite(leaf).all()


@pytest.mark.parametrize("cold_store", ["mem", "mmap"])
def test_torch_nonfinite_guard_rejected_for_async_hotcold(tmp_path,
                                                          cold_store):
    """The async store refuses the guard, with the reference's message."""
    from repro.core import scale_hyperparams as jax_scale_hyperparams
    from repro.embed import EmbeddingStore as JaxEmbeddingStore
    from repro.models import ctr as jax_ctr

    cfg, hp, _, _ = _guard_setup()
    store = EmbeddingStore(placement="hotcold", hot_capacity=16,
                           cold_store=cold_store,
                           cold_dir=str(tmp_path / "port"))
    with pytest.raises(ValueError, match="async hotcold") as got:
        store.make_bundle(cfg, hp, nonfinite_guard=True)

    jcfg = jax_ctr.CTRConfig(name="deepfm", vocab_sizes=VOCABS, n_dense=3,
                             emb_dim=8, mlp_dims=(16, 16, 16),
                             emb_sigma=1e-2)
    jhp = jax_scale_hyperparams("cowclip", base_lr=1e-3, base_l2=1e-3,
                                base_batch=32, batch_size=32,
                                base_dense_lr=2e-3)
    jstore = JaxEmbeddingStore(placement="hotcold", hot_capacity=16,
                               cold_store=cold_store,
                               cold_dir=str(tmp_path / "jax"))
    with pytest.raises(ValueError) as want:
        jstore.make_bundle(jcfg, jhp, nonfinite_guard=True)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["hotcold", "hotcold_decayed"])
def test_torch_nonfinite_guard_hotcold_matches_jax(name):
    """The guarded hot/cold step against the JAX package's on ROADMAP
    section 3's input: the same params and batches (two clean, one with a
    NaN dense cell, two clean), the same skips (the reference accepts the
    sync case and skips the NaN batch), and after a flush the exported
    params within 1e-5 and the residency and frequencies exactly equal."""
    from repro.core import scale_hyperparams as jax_scale_hyperparams
    from repro.embed import store_for as jax_store_for
    from repro.models import ctr as jax_ctr

    cfg, hp, store, vocabs = _guard_setup(name)
    _, knobs = PLACEMENTS[name]
    ds = make_ctr_dataset(160, vocabs, n_dense=3, seed=7)
    batches = [_batch(ds, lo, lo + 32, poison=lo == 64)
               for lo in range(0, 160, 32)]

    jcfg = jax_ctr.CTRConfig(name="deepfm", vocab_sizes=vocabs, n_dense=3,
                             emb_dim=8, mlp_dims=(16, 16, 16),
                             emb_sigma=1e-2, placement="hotcold")
    jhp = jax_scale_hyperparams("cowclip", base_lr=1e-3, base_l2=1e-3,
                                base_batch=32, batch_size=32,
                                base_dense_lr=2e-3)
    jbundle = jax_store_for(jcfg, **knobs).make_bundle(
        jcfg, jhp, nonfinite_guard=True, use_kernel=False)
    p_np = jax.tree.map(np.asarray, jax_ctr.init(jax.random.key(0), jcfg))
    jp = jbundle.prepare(jax.tree.map(jnp.asarray, p_np))
    js = jbundle.init(jp)
    jskips = []
    for b in batches:
        jp, js, aux = jbundle.step(
            jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        jskips.append(int(aux["skipped_steps"]))
    jp, js = jbundle.flush(jp, js)

    bundle = store.make_bundle(cfg, hp, nonfinite_guard=True)
    p = bundle.prepare(params_from_numpy(p_np, "cpu"))
    s = bundle.init(p)
    skips = []
    for b in batches:
        p, s, aux = bundle.step(p, s, _tensors(b))
        skips.append(int(aux["skipped_steps"]))
    p, s = bundle.flush(p, s)

    assert jskips == skips == [0, 0, 1, 0, 0]
    assert int(s["step"]) == int(js["step"]) == 4
    want = flatten_with_paths(jax.tree.map(np.asarray, jbundle.export(jp)))
    got = flatten_with_paths(bundle.export(p))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-5, err_msg=k)
    for f in s["hot"]["slot_ids"]:
        np.testing.assert_array_equal(
            s["hot"]["slot_ids"][f].numpy(),
            np.asarray(js["hot"]["slot_ids"][f]), err_msg=f)
        np.testing.assert_array_equal(
            s["hot"]["slot_of"][f].numpy(),
            np.asarray(js["hot"]["slot_of"][f]), err_msg=f)
        np.testing.assert_array_equal(
            s["hot"]["freq"][f].numpy(), np.asarray(js["hot"]["freq"][f]),
            err_msg=f)
