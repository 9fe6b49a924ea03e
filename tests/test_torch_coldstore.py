"""The port's out-of-core cold tier and async migration
(``repro_torch.embed.coldstore``, ``repro_torch.embed.migrate``).

Moving the cold tier out of the step -- host NumPy tables ("mem") or
``np.memmap`` files ("mmap"), residency planned on the host one step
ahead, eviction values flowing back through the store-buffer -- changes
nothing about the math: within the port, async runs export params bitwise
identical to the synchronous hotcold placement (capacities 2 and 4, both
admission policies), whether steps are planned inline or on the stream's
worker thread, and across an mmap flush -> close -> reopen -> resume.
(Held to the port's own synchronous placement, not to the JAX package's
async path, which drifts an ulp on newer jax releases; the synchronous
placement itself is held to the JAX package in test_torch_hotcold.py.)

The store-buffer's read-your-writes protocol is driven through random
register / late fill / read / drain interleavings against a dict oracle,
and the on-disk layout interchanges with the JAX package's ``ColdStore``
both ways.
"""

import functools
import tempfile

import numpy as np
import pytest
import torch

try:
    import hypothesis
    import hypothesis.strategies as st
except ImportError:
    from hypcompat import hypothesis, st

from repro.embed.coldstore import ColdStore as JaxColdStore
from repro_torch.core import build_train_step
from repro_torch.core.scaling import scale_hyperparams
from repro_torch.core.tree import flatten_with_paths
from repro_torch.data import iterate_batches, make_ctr_dataset
from repro_torch.data import stream as stream_lib
from repro_torch.embed.coldstore import ColdStore, EvictionHandle, StoreBuffer
from repro_torch.models import ctr
from repro_torch.train import train_ctr

VOCABS = (60, 13, 5)
BATCH = 32
STEPS = 8


def _cfg():
    return ctr.CTRConfig(name="deepfm", vocab_sizes=VOCABS, n_dense=3,
                         emb_dim=8, mlp_dims=(16, 16, 16), emb_sigma=1e-2)


def _hp():
    return scale_hyperparams("cowclip", base_lr=1e-3, base_l2=1e-3,
                             base_batch=BATCH, batch_size=BATCH,
                             base_dense_lr=2e-3)


@functools.lru_cache(maxsize=None)
def _batches():
    ds = make_ctr_dataset(512, VOCABS, n_dense=3, zipf_a=1.2, seed=3)
    return [b for _, b in zip(range(STEPS), iterate_batches(ds, BATCH,
                                                            seed=1))]


def _bundle(capacity, **kw):
    return build_train_step(_cfg(), _hp(), path="hotcold",
                            hot_capacity=capacity, **kw)


def _init(bundle, seed=0):
    params = bundle.prepare(ctr.init(_cfg(), seed=seed, device="cpu"))
    return params, bundle.init(params)


def _steps(bundle, params, state, batches):
    auxes = []
    for b in batches:
        params, state, aux = bundle.step(
            params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        auxes.append({k: float(v) for k, v in aux.items()})
    return params, state, auxes


def _export(bundle, params):
    return {k: v.clone().numpy() for k, v in
            flatten_with_paths(bundle.export(params)).items()}


def _run_inline(capacity, **kw):
    bundle = _bundle(capacity, **kw)
    params, state = _init(bundle)
    params, state, auxes = _steps(bundle, params, state, _batches())
    params, state = bundle.flush(params, state)
    return _export(bundle, params), auxes


@functools.lru_cache(maxsize=None)
def _run_cached(capacity, cold_store="none", admission="cumulative",
                half_life=0):
    kw = {} if cold_store == "none" else {"cold_store": cold_store}
    return _run_inline(capacity, admission=admission, half_life=half_life,
                       **kw)


def _assert_bitwise(a, b, msg=""):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{msg}{k}")


@pytest.mark.parametrize("capacity", [2, 4])
def test_torch_async_mem_bitwise_matches_sync(capacity):
    """Host planning + store-buffered evictions reproduce the synchronous
    step bit for bit: same losses, residency counts and exported params."""
    sync, sync_aux = _run_cached(capacity)
    am, am_aux = _run_cached(capacity, cold_store="mem")
    _assert_bitwise(sync, am)
    for sa, aa in zip(sync_aux, am_aux):
        for k in ("loss", "catchup_depth_max", "hot_hit_rows",
                  "hot_lookup_rows", "evictions"):
            assert sa[k] == aa[k], (k, sa, aa)


def test_torch_async_mmap_bitwise_matches_mem():
    am, _ = _run_cached(4, cold_store="mem")
    with tempfile.TemporaryDirectory() as d:
        mm, _ = _run_inline(4, cold_store="mmap", cold_dir=d)
    _assert_bitwise(am, mm)


def test_torch_async_capacity_runs_bitwise_identical():
    _assert_bitwise(_run_cached(2, cold_store="mem")[0],
                    _run_cached(100, cold_store="mem")[0])


def test_torch_decayed_admission_async_matches_sync():
    """The host planner's f32 frequency arithmetic (NumPy) agrees with the
    step's (PyTorch) bit for bit under the decayed policy too."""
    sync, sync_aux = _run_cached(4, admission="decayed", half_life=3)
    am, am_aux = _run_cached(4, cold_store="mem", admission="decayed",
                             half_life=3)
    _assert_bitwise(sync, am)
    assert [a["hot_hit_rows"] for a in sync_aux] == \
        [a["hot_hit_rows"] for a in am_aux]


def _run_driver(capacity, **kw):
    bundle = _bundle(capacity, **kw)

    def events():
        yield from _batches()

    stream = stream_lib.stream_chunks(
        events(), BATCH, 1, buffer_size=4,
        transform=bundle.stream_transform(max_steps=STEPS))
    res = train_ctr(_cfg(), None, None, None, batch_size=BATCH,
                    step_bundle=bundle, max_steps=STEPS, engine="scan",
                    mode="stream", stream=stream, device="cpu")
    return _export(bundle, res.params), res, bundle.stream_driver.__self__


def test_torch_overlapped_driver_bitwise_matches_inline():
    """Planning on the stream's worker thread (lookahead = buffer_size)
    reorders nothing: the overlapped drive bit-matches the inline steps
    and the synchronous placement, losses included."""
    sync, sync_aux = _run_cached(4)
    drv, res, ctrl = _run_driver(4, cold_store="mem")
    _assert_bitwise(sync, drv)
    assert res.steps == STEPS
    assert res.losses == [a["loss"] for a in sync_aux]
    stats = ctrl.last_stream_stats
    assert stats["steps"] == STEPS
    assert 0.0 <= stats["migration_overlap_fraction"] <= 1.0
    assert stats["cold_gather_bytes"] > 0
    assert stats["plan_bytes_to_device"] > 0
    assert stats["evict_bytes_from_device"] > 0
    assert ctrl.buffer_pending() == 0


def test_torch_transform_rejects_multi_batch_chunks():
    bundle = _bundle(4, cold_store="mem")
    _init(bundle)
    transform = bundle.stream_transform(max_steps=STEPS)
    chunk = {k: np.stack([v, v]) for k, v in _batches()[0].items()}
    with pytest.raises(ValueError, match="scan_steps=1"):
        transform(chunk)


def test_torch_transform_enforces_step_budget():
    """The budget lives at the source: the transform ends the stream, so
    no planned step is ever dropped (capacity >= vocab: nothing evicts, so
    planning without a consumer cannot wait on its own write-backs)."""
    bundle = _bundle(100, cold_store="mem")
    _init(bundle)
    transform = bundle.stream_transform(max_steps=2)
    chunk = {k: v[None] for k, v in _batches()[0].items()}
    assert transform(dict(chunk)) is not None
    assert transform(dict(chunk)) is not None
    assert transform(dict(chunk)) is None


def test_torch_mmap_flush_reopen_resume_bitexact():
    """Flush at step 4, close the store, reopen the directory in a fresh
    bundle (its params initialised from another seed: the directory and
    its sidecar define the model) and run steps 5-8: bit-identical to an
    uninterrupted run flushed at the same step."""
    bs = _batches()
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        b1 = _bundle(4, cold_store="mmap", cold_dir=d1)
        p, s = _init(b1)
        p, s, _ = _steps(b1, p, s, bs[:4])
        p, s = b1.flush(p, s)
        p, s, _ = _steps(b1, p, s, bs[4:])
        p, s = b1.flush(p, s)
        ref = _export(b1, p)

        b2 = _bundle(4, cold_store="mmap", cold_dir=d2)
        p, s = _init(b2)
        p, s, _ = _steps(b2, p, s, bs[:4])
        b2.flush(p, s)
        b2.stream_driver.__self__.store.close()

        b3 = _bundle(4, cold_store="mmap", cold_dir=d2)
        p, s = _init(b3, seed=1)
        ctrl3 = b3.stream_driver.__self__
        assert ctrl3.store.resumed and ctrl3.planner.t == 4
        p, s, _ = _steps(b3, p, s, bs[4:])
        p, s = b3.flush(p, s)
        _assert_bitwise(ref, _export(b3, p))


def test_torch_async_flush_is_bitwise_idempotent():
    bundle = _bundle(4, cold_store="mem")
    p, s = _init(bundle)
    p, s, _ = _steps(bundle, p, s, _batches())
    p, s = bundle.flush(p, s)
    once = _export(bundle, p)
    p, s = bundle.flush(p, s)
    _assert_bitwise(once, _export(bundle, p))


def test_torch_snapshots_name_their_roadmap_item():
    """The controller's snapshots (once a refusal naming ROADMAP queue 1
    item 6, now ported): the flushed state exported under the
    reference's keys and imported into a fresh bundle continues bitwise
    as the bundle that exported it."""
    bs = _batches()
    bundle = _bundle(4, cold_store="mem")
    ctrl = bundle.stream_driver.__self__
    p, s = _init(bundle)
    p, s, _ = _steps(bundle, p, s, bs[:4])
    p, s = bundle.flush(p, s)
    leaves = ctrl.export_snapshot(p, s)
    assert int(leaves["t"]) == 4
    assert {k.split("/")[0] for k in leaves} == {
        "t", "slot_ids", "slot_of", "slot_ls", "freq", "ls", "cold_w",
        "cold_m", "cold_v", "dense_param", "dense_opt"}
    p, s, _ = _steps(bundle, p, s, bs[4:])
    p, s = bundle.flush(p, s)

    fresh = _bundle(4, cold_store="mem")
    p2, _ = _init(fresh)
    p2, s2 = fresh.stream_driver.__self__.import_snapshot(leaves, p2)
    assert s2["step"] == 4
    p2, s2, _ = _steps(fresh, p2, s2, bs[4:])
    p2, s2 = fresh.flush(p2, s2)
    _assert_bitwise(_export(bundle, p), _export(fresh, p2))


# ---------------------------------------------------------------------------
# ColdStore
# ---------------------------------------------------------------------------

SPEC = {"fm": {"field_0": (20, 4, "float32")},
        "lin": {"field_0": (20, 1, "float32")}}


def _rows():
    return {"w": {"fm": np.ones((2, 4), np.float32),
                  "lin": np.ones((2, 1), np.float32)},
            "m": {"fm": np.full((2, 4), 2, np.float32),
                  "lin": np.full((2, 1), 2, np.float32)},
            "v": {"fm": np.full((2, 4), 3, np.float32),
                  "lin": np.full((2, 1), 3, np.float32)},
            "ls": np.asarray([7, 9], np.int32)}


def test_torch_store_mem_mmap_gather_scatter_agree():
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(20, 4)).astype(np.float32)
    mem = ColdStore.create(SPEC, backend="mem")
    with tempfile.TemporaryDirectory() as d:
        mm = ColdStore.create(SPEC, backend="mmap", directory=d)
        ids = np.asarray([3, 11])
        for store in (mem, mm):
            store.w["fm"]["field_0"][...] = w0
            store.scatter("field_0", ids, _rows())
        g_mem, g_mm = mem.gather("field_0", ids), mm.gather("field_0", ids)
        for key in ("w", "m", "v"):
            for g in ("fm", "lin"):
                np.testing.assert_array_equal(g_mem[key][g], g_mm[key][g])
                np.testing.assert_array_equal(g_mem[key][g], _rows()[key][g])
        np.testing.assert_array_equal(g_mem["ls"], _rows()["ls"])
        for store in (mem, mm):
            np.testing.assert_array_equal(
                store.gather("field_0", [0])["w"]["fm"], w0[:1])
        assert mem.gather_bytes == mm.gather_bytes > 0
        assert mem.table_bytes() == mm.table_bytes()
        mm.close()


def test_torch_store_rejects_bad_backend():
    with pytest.raises(ValueError, match="backend"):
        ColdStore("ssd")
    with pytest.raises(ValueError, match="directory"):
        ColdStore("mmap")


def _fill_store(store, seed):
    rng = np.random.default_rng(seed)
    for tables in (store.w, store.m, store.v):
        for g in store.groups:
            for f in store.fields:
                tables[g][f][...] = rng.normal(size=tables[g][f].shape)
    for f in store.fields:
        store.ls[f][...] = rng.integers(0, 100, store.ls[f].shape)
    store.flush_files()


def _store_arrays(store):
    out = {f"ls/{f}": np.array(store.ls[f]) for f in store.fields}
    for name, tables in (("w", store.w), ("m", store.m), ("v", store.v)):
        for g in store.groups:
            for f in store.fields:
                out[f"{name}/{g}/{f}"] = np.array(tables[g][f])
    return out


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_torch_store_directory_interchanges_with_jax(writer):
    """A directory written by one package's ColdStore opens in the
    other's with every array bitwise equal, and the sidecar too."""
    make, reopen = ((JaxColdStore, ColdStore) if writer == "jax"
                    else (ColdStore, JaxColdStore))
    with tempfile.TemporaryDirectory() as d:
        store = make.create(SPEC, backend="mmap", directory=d)
        _fill_store(store, seed=5)
        store.save_sidecar({"t": np.int64(3),
                            "freq/field_0": np.arange(20, dtype=np.float32)})
        want = _store_arrays(store)
        store.close()
        other = reopen.open(d)
        assert other.resumed and other.groups == ["fm", "lin"]
        _assert_bitwise(want, _store_arrays(other))
        side = other.load_sidecar()
        assert int(side["t"]) == 3
        np.testing.assert_array_equal(side["freq/field_0"],
                                      np.arange(20, dtype=np.float32))
        other.close()


# ---------------------------------------------------------------------------
# the store-buffer's read-your-writes under random interleavings
# ---------------------------------------------------------------------------


def _fresh_buffer(vocab=12, dim=3):
    store = ColdStore.create({"fm": {"field_0": (vocab, dim, "float32")}},
                             backend="mem")
    store.w["fm"]["field_0"][...] = np.arange(
        vocab * dim, dtype=np.float32).reshape(vocab, dim)
    return store, StoreBuffer(store)


def _bank_arrays(bank):
    return {k: {"fm": {"field_0": bank * s}}
            for k, s in (("w", 1), ("m", 0), ("v", 0))}


@hypothesis.given(seed=st.integers(0, 63))
@hypothesis.settings(max_examples=24, deadline=None)
def test_torch_store_buffer_read_your_writes(seed):
    """Random register / late fill / read / drain against a dict oracle:
    a read always observes the newest registered write for an id, drains
    never lose or reorder writes, and a final drain_all leaves the store
    equal to the oracle."""
    rng = np.random.default_rng(seed)
    vocab, dim = 12, 3
    store, buf = _fresh_buffer(vocab, dim)
    oracle = {i: store.w["fm"]["field_0"][i].copy() for i in range(vocab)}
    unfilled = []
    step = 0
    for _ in range(30):
        op = rng.integers(0, 4)
        if op == 0:                                # evict: register a step
            step += 1
            n = int(rng.integers(1, 4))
            ids = rng.choice(vocab, size=n, replace=False)
            bank = rng.normal(size=(n, dim)).astype(np.float32)
            handle = EvictionHandle()
            buf.register("field_0", ids, np.full(n, step, np.int32),
                         np.arange(n), step, handle)
            for k, i in enumerate(ids):
                oracle[int(i)] = bank[k].copy()
            unfilled.append((handle, bank))
            if rng.integers(0, 2):                 # sometimes fill late
                continue
            op = 1
        if op == 1 and unfilled:                   # fill the oldest handle
            handle, bank = unfilled.pop(0)
            handle.fill(_bank_arrays(bank))
        elif op == 2:                              # read-your-writes
            ids = rng.choice(vocab, size=int(rng.integers(1, 5)),
                             replace=True)
            for handle, bank in unfilled:          # single-threaded here
                handle.fill(_bank_arrays(bank))
            unfilled.clear()
            out = buf.read("field_0", ids)
            for k, i in enumerate(ids):
                np.testing.assert_array_equal(
                    out["w"]["fm"][k], oracle[int(i)],
                    err_msg=f"id {i} at seed {seed}")
        elif op == 3:                              # opportunistic drain
            buf.drain(ready_only=True)
    for handle, bank in unfilled:
        handle.fill(_bank_arrays(bank))
    buf.drain_all()
    assert buf.pending() == 0
    for i in range(vocab):
        np.testing.assert_array_equal(store.w["fm"]["field_0"][i],
                                      oracle[i], err_msg=f"store id {i}")


def test_torch_store_buffer_newest_entry_wins():
    store, buf = _fresh_buffer()
    h1, h2 = EvictionHandle(), EvictionHandle()
    old = np.full((1, 3), 5.0, np.float32)
    new = np.full((1, 3), 9.0, np.float32)
    buf.register("field_0", np.asarray([4]), np.asarray([1], np.int32),
                 np.arange(1), 1, h1)
    buf.register("field_0", np.asarray([4]), np.asarray([2], np.int32),
                 np.arange(1), 2, h2)
    h1.fill({k: {"fm": {"field_0": old}} for k in ("w", "m", "v")})
    h2.fill({k: {"fm": {"field_0": new}} for k in ("w", "m", "v")})
    out = buf.read("field_0", np.asarray([4]))
    np.testing.assert_array_equal(out["w"]["fm"][0], new[0])
    assert out["ls"][0] == 2
    buf.drain_all()
    assert buf.pending() == 0
    np.testing.assert_array_equal(store.w["fm"]["field_0"][4], new[0])
    assert store.ls["field_0"][4] == 2


def test_torch_store_buffer_drain_ready_only_skips_inflight():
    store, buf = _fresh_buffer()
    h = EvictionHandle()
    buf.register("field_0", np.asarray([2]), np.asarray([1], np.int32),
                 np.arange(1), 1, h)
    assert buf.drain(ready_only=True) == 0
    assert buf.pending() == 1
    h.fill({k: {"fm": {"field_0": np.ones((1, 3), np.float32)}}
            for k in ("w", "m", "v")})
    assert buf.drain(ready_only=True) == 1
    assert buf.pending() == 0
