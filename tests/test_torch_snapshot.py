"""The port's crash-safe snapshots (``repro_torch.train.snapshot``):
manifest atomicity, checksum fallback, retain-N rotation, and exact
resume. A port of ``tests/test_snapshot.py``.

The headline contract: a trainer SIGKILLed at an arbitrary step and
restarted with ``--resume`` exports params **bitwise identical** to an
uninterrupted run with the same ``--snapshot-every`` cadence (each
snapshot's flush settles pending lazy decay, so the cadence is part of
the trajectory). The subprocess matrix proves it end to end, through
``repro_torch.launch.train``, a real SIGKILL and a fresh process: for
the sparse placement (a kill with pending lazy-decay depth), a kill
*inside* the snapshot write (the torn ``*.tmp`` must be ignored), the
async hot/cold placement over an mmap ColdStore, and the synchronous
hot/cold placement with the non-finite guard.

The format is the JAX package's: a sparse snapshot written by either
package resumes in the other, and the next steps agree within 1e-5
(``--base-l2 0``, as the reference's cross-placement gates use).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.scaling import scale_hyperparams
from repro_torch.core.tree import flatten_with_paths, tree_leaves
from repro_torch.data import iterate_batches, make_ctr_dataset
from repro_torch.data.stream import (skip_rows, stream_chunks,
                                     synthetic_event_stream)
from repro_torch.embed.store import EmbeddingStore, store_for
from repro_torch.models import ctr
from repro_torch.testing import FaultPlan
from repro_torch.train import train_ctr
from repro_torch.train.checkpoint import params_from_numpy
from repro_torch.train.snapshot import (SnapshotManager, capture,
                                        controller_of, overlay,
                                        placement_token, resume)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCABS = (60, 13, 5)


# ---------------------------------------------------------------------------
# SnapshotManager units
# ---------------------------------------------------------------------------


def _save(mgr, step, value=None):
    return mgr.save(step, {"canonical": {"x": np.full((3,), value
                                                      if value is not None
                                                      else step,
                                                      np.float32)}},
                    {"step": step, "cursor": {"rows_consumed": step * 8}})


def test_torch_save_validate_roundtrip(tmp_path):
    mgr = SnapshotManager(str(tmp_path))
    path = _save(mgr, 4)
    assert mgr.validate(path)
    step, found = mgr.latest_valid()
    assert step == 4 and found == path
    manifest = mgr.read_manifest(path)
    assert manifest["meta"]["cursor"]["rows_consumed"] == 32
    assert "canonical.npz" in manifest["files"]
    np.testing.assert_array_equal(mgr.load_arrays(path, "canonical")["x"],
                                  np.full((3,), 4, np.float32))
    timings = mgr.last_timings
    assert set(timings) == {"write", "sha256", "manifest", "bytes"}
    assert timings["bytes"] == os.path.getsize(
        os.path.join(path, "canonical.npz"))

    # the JAX package reads and validates the same directory
    from repro.train.snapshot import SnapshotManager as JaxSnapshotManager
    assert JaxSnapshotManager(str(tmp_path)).latest_valid() == (4, path)


def test_torch_torn_tmp_dir_is_not_a_snapshot(tmp_path):
    """A crash before the rename leaves ``snap-*.tmp`` — invisible to
    resume, and garbage-collected by the next successful save."""
    mgr = SnapshotManager(str(tmp_path))
    _save(mgr, 4)
    torn = tmp_path / "snap-00000008.tmp"
    torn.mkdir()
    (torn / "canonical.npz").write_bytes(b"half a payload")
    assert mgr.latest_valid()[0] == 4
    _save(mgr, 12)
    assert not torn.exists()
    assert mgr.latest_valid()[0] == 12


def test_torch_corrupted_latest_falls_back_to_previous(tmp_path):
    """Bit-rot in the newest snapshot (checksum mismatch) falls back to
    the previous valid one; a corrupt manifest too."""
    mgr = SnapshotManager(str(tmp_path))
    _save(mgr, 4)
    p8 = _save(mgr, 8)
    payload = os.path.join(p8, "canonical.npz")
    raw = bytearray(open(payload, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(payload, "wb").write(bytes(raw))
    assert not mgr.validate(p8)
    assert mgr.latest_valid()[0] == 4

    p12 = _save(mgr, 12)
    open(os.path.join(p12, "manifest.json"), "w").write("{not json")
    assert mgr.latest_valid()[0] == 4


def test_torch_retain_rotation(tmp_path):
    mgr = SnapshotManager(str(tmp_path), retain=2)
    for s in (4, 8, 12, 16):
        _save(mgr, s)
    assert mgr.list_steps() == [12, 16]
    assert mgr.latest_valid()[0] == 16


def test_torch_retain_validates(tmp_path):
    with pytest.raises(ValueError, match="retain"):
        SnapshotManager(str(tmp_path / "never-created"), retain=0)
    assert not (tmp_path / "never-created").exists()


def test_torch_mid_snapshot_kill_hook_fires_between_payload_and_manifest(
        tmp_path, monkeypatch):
    """The fault hook runs after payloads exist but before the manifest /
    rename — exactly the torn-write window. Simulate the kill with an
    exception and check nothing was published."""
    class Boom(BaseException):
        pass

    plan = FaultPlan(kill_at_step=8, kill_in_snapshot=True)
    monkeypatch.setattr("repro_torch.testing.faults.kill_now",
                        lambda: (_ for _ in ()).throw(Boom()))
    mgr = SnapshotManager(str(tmp_path), fault_plan=plan)
    _save(mgr, 4)
    with pytest.raises(Boom):
        _save(mgr, 8)
    assert mgr.latest_valid()[0] == 4


def test_torch_overlay_roundtrips_scalars_and_arrays():
    """Tensor leaves come back as tensors of the template's dtype and
    device, Python int leaves (step counters) as ints."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": (torch.tensor(7, dtype=torch.int32), 3)}
    flat = {"a": np.arange(6, dtype=np.float32).reshape(2, 3) + 1,
            "b/0": np.asarray(np.int32(9)), "b/1": np.asarray(4)}
    out = overlay(tree, flat)
    assert torch.equal(out["a"], tree["a"] + 1)
    assert out["b"][0].dtype == torch.int32 and int(out["b"][0]) == 9
    assert out["b"][0].shape == ()
    assert out["b"][1] == 4 and isinstance(out["b"][1], int)
    with pytest.raises(KeyError, match="missing leaf"):
        overlay(tree, {"a": flat["a"], "b/0": flat["b/0"]})
    with pytest.raises(ValueError, match="shape"):
        overlay({"a": torch.zeros((2, 2))}, {"a": np.zeros((3,))})


# ---------------------------------------------------------------------------
# in-process capture/resume: bitwise continuation
# ---------------------------------------------------------------------------


def _setup(placement="sparse", base_l2=1e-3):
    cfg = ctr.CTRConfig(name="deepfm", vocab_sizes=VOCABS, n_dense=3,
                        emb_dim=8, mlp_dims=(16, 16, 16), emb_sigma=1e-2,
                        sparse=placement == "sparse", placement=placement)
    hp = scale_hyperparams("cowclip", base_lr=1e-3, base_l2=base_l2,
                           base_batch=32, batch_size=32, base_dense_lr=2e-3)
    ds = make_ctr_dataset(600, VOCABS, n_dense=3, zipf_a=1.2, seed=9)
    tr, te = ds.split(0.8)
    store = store_for(cfg, hot_capacity=8)

    def make_stream(skip=0):
        ev = synthetic_event_stream(tr, rows_per_event=48, seed=1)
        return stream_chunks(skip_rows(ev, skip) if skip else ev, 32, 2,
                             start_rows=skip)

    def init_params():
        return ctr.init(cfg, seed=0, device="cpu")

    return cfg, hp, tr, te, store, make_stream, init_params


def _export_leaves(bundle, params):
    return [t.clone() for t in tree_leaves(bundle.export(params))]


@pytest.mark.parametrize("placement", ["sparse", "hotcold"])
def test_torch_inprocess_resume_is_bitwise(tmp_path, placement):
    """train_ctr + snapshot_cb, then a fresh bundle resumed mid-run from
    the snapshot dir: exported params and the whole state match an
    uninterrupted run with the same cadence, bit for bit."""
    cfg, hp, tr, _, store, make_stream, init_params = _setup(placement)
    token = placement_token(store)

    def run(snap_dir, *, start=0, init_state=None, max_steps=12,
            bundle=None):
        bundle = bundle or store.make_bundle(cfg, hp)
        mgr = SnapshotManager(snap_dir)
        last = [start]

        def cb(params, state, n):
            if n - last[0] >= 4:
                params, state = capture(
                    mgr, bundle, params, state, step=n,
                    cursor={"rows_consumed": n * 32},
                    meta={"placement": token})
                last[0] = n
            return params, state

        res = train_ctr(cfg, None, tr, None, batch_size=32, seed=0,
                        step_bundle=bundle, engine="scan", mode="stream",
                        stream=make_stream(start * 32), max_steps=max_steps,
                        init_state=init_state, start_step=start,
                        snapshot_cb=cb, device="cpu")
        return bundle, res

    # reference: uninterrupted, snapshots every 4 of 12 steps
    bundle_a, res_a = run(str(tmp_path / "a"))
    leaves_a = _export_leaves(bundle_a, res_a.params)

    # interrupted: run only to step 8 (snapshots at 4 and 8), then resume
    # from the dir with a *fresh* bundle and finish
    run(str(tmp_path / "b"), max_steps=8)
    mgr_b = SnapshotManager(str(tmp_path / "b"))
    bundle_b = store.make_bundle(cfg, hp)
    restored = resume(mgr_b, bundle_b, init_params(), token=token)
    assert restored is not None
    params, state, start, cursor = restored
    assert start == 8 and cursor["rows_consumed"] == 256
    assert int(state["step"]) == 8
    _, res_b = run(str(tmp_path / "b"), start=start,
                   init_state=(params, state), bundle=bundle_b)
    leaves_b = _export_leaves(bundle_b, res_b.params)
    assert res_b.steps == res_a.steps == 12
    for a, b in zip(leaves_a, leaves_b):
        assert torch.equal(a, b)
    for (k, a), b in zip(flatten_with_paths(res_a.opt_state).items(),
                         tree_leaves(res_b.opt_state)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), k


@pytest.mark.parametrize("backend", ["mem", "mmap"])
def test_torch_async_hotcold_snapshot_resumes_in_fresh_bundle(tmp_path,
                                                              backend):
    """The async hot/cold placement: a snapshot (the controller's leaves
    for ``mem``, the store directory for ``mmap``) resumed in a fresh
    bundle continues bitwise as the bundle that wrote it."""
    cfg, hp, tr, _, _, _, init_params = _setup("hotcold")
    batches = [b for _, b in zip(range(8), iterate_batches(tr, 32, seed=2))]

    def make(cold_dir):
        store = EmbeddingStore(placement="hotcold", hot_capacity=8,
                               cold_store=backend,
                               cold_dir=str(cold_dir))
        return store, store.make_bundle(cfg, hp)

    def steps(bundle, params, state, bs):
        for b in bs:
            params, state, _ = bundle.step(
                params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        return bundle.flush(params, state)

    store, bundle = make(tmp_path / "live")
    params = bundle.prepare(init_params())
    state = bundle.init(params)
    params, state = steps(bundle, params, state, batches[:4])
    mgr = SnapshotManager(str(tmp_path / "snaps"))
    params, state = capture(mgr, bundle, params, state, step=4,
                            cursor={"rows_consumed": 128},
                            meta={"placement": placement_token(store)})
    listing = os.listdir(os.path.join(str(tmp_path / "snaps"),
                                      "snap-00000004"))
    assert ("cold_store" in listing) == (backend == "mmap")
    assert ("async_hotcold.npz" in listing) == (backend == "mem")
    params, state = steps(bundle, params, state, batches[4:])
    want = _export_leaves(bundle, params)

    store2, bundle2 = make(tmp_path / "resumed")
    p2, s2, step, _ = resume(mgr, bundle2, init_params(),
                             token=placement_token(store2),
                             cold_dir=str(tmp_path / "resumed"))
    assert step == 4 and s2["step"] == 4
    assert controller_of(bundle2) is not controller_of(bundle)
    p2, s2 = steps(bundle2, p2, s2, batches[4:])
    for a, b in zip(want, _export_leaves(bundle2, p2)):
        assert torch.equal(a, b)
    assert s2["step"] == state["step"] == 8


def test_torch_cross_placement_resume_is_params_only(tmp_path):
    """A snapshot written by one placement resumes under another:
    canonical params restore, optimizer starts fresh, and the caller is
    warned."""
    cfg, hp, tr, _, store, make_stream, init_params = _setup()
    bundle = store.make_bundle(cfg, hp)
    params = bundle.prepare(init_params())
    state = bundle.init(params)
    stream = make_stream()
    for chunk in stream:
        for i in range(chunk["labels"].shape[0]):
            batch = {k: torch.from_numpy(np.asarray(v[i]))
                     for k, v in chunk.items()}
            params, state, _ = bundle.step(params, state, batch)
        break
    stream.close()
    mgr = SnapshotManager(str(tmp_path))
    params, state = capture(mgr, bundle, params, state, step=2,
                            cursor={"rows_consumed": 64},
                            meta={"placement": "sparse:auto:none"})

    warnings = []
    sub_bundle = store_for(cfg, path="substrate").make_bundle(cfg, hp)
    restored = resume(mgr, sub_bundle, init_params(),
                      token="dense:substrate:none", warn=warnings.append)
    assert restored is not None
    r_params, r_state, r_step, _ = restored
    assert r_step == 2
    assert warnings and "params-only" in warnings[0]
    fresh = sub_bundle.init(sub_bundle.prepare(init_params()))
    for a, b in zip(tree_leaves(fresh), tree_leaves(r_state)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    for a, b in zip(_export_leaves(bundle, params),
                    _export_leaves(sub_bundle, r_params)):
        assert torch.equal(a, b)


def test_torch_resume_empty_dir_returns_none(tmp_path):
    cfg, hp, _, _, store, _, init_params = _setup()
    bundle = store.make_bundle(cfg, hp)
    mgr = SnapshotManager(str(tmp_path))
    assert resume(mgr, bundle, init_params(),
                  token="sparse:auto:none") is None


# ---------------------------------------------------------------------------
# interchange with the JAX package
# ---------------------------------------------------------------------------


def _jax_sparse(vocabs=VOCABS):
    import jax

    from repro.core import scale_hyperparams as jax_scale_hyperparams
    from repro.embed import store_for as jax_store_for
    from repro.models import ctr as jax_ctr

    cfg = jax_ctr.CTRConfig(name="deepfm", vocab_sizes=vocabs, n_dense=3,
                            emb_dim=8, mlp_dims=(16, 16, 16),
                            emb_sigma=1e-2, sparse=True, placement="sparse")
    hp = jax_scale_hyperparams("cowclip", base_lr=1e-3, base_l2=0.0,
                               base_batch=32, batch_size=32,
                               base_dense_lr=2e-3)
    store = jax_store_for(cfg)
    params = jax.tree.map(np.asarray, jax_ctr.init(jax.random.key(0), cfg))
    return cfg, hp, store, params


def _interchange_data():
    ds = make_ctr_dataset(600, VOCABS, n_dense=3, zipf_a=1.2, seed=9)
    tr, te = ds.split(0.8)
    return [b for _, b in zip(range(8), iterate_batches(tr, 32, seed=2))], te


def _jax_steps(bundle, params, state, batches):
    import jax.numpy as jnp

    for b in batches:
        params, state, _ = bundle.step(
            params, state, {k: jnp.asarray(v) for k, v in b.items()})
    return bundle.flush(params, state)


def _port_steps(bundle, params, state, batches):
    for b in batches:
        params, state, _ = bundle.step(
            params, state, {k: torch.from_numpy(v) for k, v in b.items()})
    return bundle.flush(params, state)


def _jax_auc(cfg, params, te):
    import jax
    import jax.numpy as jnp

    from repro.data.synthetic import CTRDataset as JaxCTRDataset
    from repro.train.loop import make_eval_fn as jax_make_eval_fn

    ds = JaxCTRDataset(te.ids, te.dense, te.labels, te.vocab_sizes)
    return jax_make_eval_fn(cfg)(jax.tree.map(jnp.asarray, params),
                                 ds)["auc"]


def _compare(port_params, jax_params, tol=1e-5):
    want = flatten_with_paths(jax_params)
    got = flatten_with_paths(port_params)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=0, atol=tol,
                                   err_msg=k)


def test_torch_snapshot_written_by_jax_resumes_in_port(tmp_path):
    """A sparse snapshot the JAX package wrote after 4 steps resumes in
    the port; its next 4 steps match JAX's within 1e-5 (params and AUC)."""
    import jax
    import jax.numpy as jnp

    from repro.train import snapshot as jax_snapshot

    jcfg, jhp, jstore, p_np = _jax_sparse()
    batches, te = _interchange_data()
    jbundle = jstore.make_bundle(jcfg, jhp, use_kernel=False)
    jp = jbundle.prepare(jax.tree.map(jnp.asarray, p_np))
    js = jbundle.init(jp)
    jp, js = _jax_steps(jbundle, jp, js, batches[:4])
    jmgr = jax_snapshot.SnapshotManager(str(tmp_path))
    jp, js = jax_snapshot.capture(
        jmgr, jbundle, jp, js, step=4, cursor={"rows_consumed": 128},
        meta={"placement": jax_snapshot.placement_token(jstore)})
    jp, js = _jax_steps(jbundle, jp, js, batches[4:])
    jax_params = jax.tree.map(np.asarray, jbundle.export(jp))

    cfg, hp, _, _, store, _, _ = _setup(base_l2=0.0)
    bundle = store.make_bundle(cfg, hp)
    assert placement_token(store) == jax_snapshot.placement_token(jstore)
    p, s, step, cursor = resume(
        SnapshotManager(str(tmp_path)), bundle,
        params_from_numpy(p_np, "cpu"), token=placement_token(store))
    assert step == 4 and int(s["step"]) == 4 and cursor["rows_consumed"] \
        == 128
    p, s = _port_steps(bundle, p, s, batches[4:])
    _compare(bundle.export(p), jax_params)
    from repro_torch.train import make_eval_fn
    auc = make_eval_fn(cfg)(bundle.export(p), te)["auc"]
    assert abs(auc - _jax_auc(jcfg, jax_params, te)) <= 1e-5


def test_torch_snapshot_written_by_port_resumes_in_jax(tmp_path):
    """The other way: the port's sparse snapshot after 4 steps resumes in
    the JAX package, whose next 4 steps match the port's within 1e-5."""
    import jax
    import jax.numpy as jnp

    from repro.train import snapshot as jax_snapshot

    jcfg, jhp, jstore, p_np = _jax_sparse()
    batches, te = _interchange_data()
    cfg, hp, _, _, store, _, _ = _setup(base_l2=0.0)
    bundle = store.make_bundle(cfg, hp)
    p = bundle.prepare(params_from_numpy(p_np, "cpu"))
    s = bundle.init(p)
    p, s = _port_steps(bundle, p, s, batches[:4])
    mgr = SnapshotManager(str(tmp_path))
    p, s = capture(mgr, bundle, p, s, step=4,
                   cursor={"rows_consumed": 128},
                   meta={"placement": placement_token(store)})
    p, s = _port_steps(bundle, p, s, batches[4:])

    jbundle = jstore.make_bundle(jcfg, jhp, use_kernel=False)
    restored = jax_snapshot.resume(
        jax_snapshot.SnapshotManager(str(tmp_path)), jbundle,
        jax.tree.map(jnp.asarray, p_np),
        token=jax_snapshot.placement_token(jstore))
    jp, js, step, _ = restored
    assert step == 4 and int(js["step"]) == 4
    jp, js = _jax_steps(jbundle, jp, js, batches[4:])
    jax_params = jax.tree.map(np.asarray, jbundle.export(jp))
    _compare(bundle.export(p), jax_params)
    from repro_torch.train import make_eval_fn
    auc = make_eval_fn(cfg)(bundle.export(p), te)["auc"]
    assert abs(auc - _jax_auc(jcfg, jax_params, te)) <= 1e-5


# ---------------------------------------------------------------------------
# subprocess SIGKILL matrix (the real thing: launch CLI, SIGKILL, resume)
# ---------------------------------------------------------------------------


def _train_cmd(snap_dir, extra):
    return [sys.executable, "-m", "repro_torch.launch.train", "--task",
            "ctr", "--device", "cpu", "--mode", "stream", "--steps", "12",
            "--samples", "2048", "--batch", "128", "--base-batch", "128",
            "--snapshot-every", "4", "--snapshot-dir", snap_dir] + extra


def _run(cmd, plan=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("REPRO_FAULT_PLAN", None)
    if plan is not None:
        env.update(plan.to_env())
    return subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=600)


def _params_of(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files if k.startswith("params/")}


@pytest.mark.parametrize("case, place_args, plan", [
    # kill lands at a chunk boundary between snapshots, i.e. with
    # non-zero pending lazy-decay depth in the live sparse state
    ("sparse_boundary",
     ["--placement", "sparse", "--engine", "scan", "--scan-steps", "2"],
     FaultPlan(kill_at_step=6)),
    # kill lands INSIDE the snapshot write at step 8: payloads written,
    # manifest/rename never happens -> torn .tmp, resume uses step 4
    ("sparse_mid_snapshot",
     ["--placement", "sparse", "--engine", "scan", "--scan-steps", "2"],
     FaultPlan(kill_at_step=8, kill_in_snapshot=True)),
    # the async hot/cold placement over an out-of-core mmap ColdStore:
    # snapshot copies the store directory, resume reopens it
    ("hotcold_async_mmap",
     ["--placement", "hotcold", "--cold-store", "mmap",
      "--hot-capacity", "64"],
     FaultPlan(kill_at_step=6)),
    # the synchronous hot/cold placement under the non-finite guard
    ("hotcold_sync_guard",
     ["--placement", "hotcold", "--hot-capacity", "64", "--engine", "scan",
      "--scan-steps", "2", "--nonfinite-guard"],
     FaultPlan(kill_at_step=10)),
])
def test_torch_sigkill_resume_bitwise(tmp_path, case, place_args, plan):
    if "mmap" in case:
        place_args = place_args + ["--cold-dir",
                                   str(tmp_path / "cold_live")]

    ref_args = list(place_args)
    if "mmap" in case:
        ref_args[ref_args.index(str(tmp_path / "cold_live"))] = \
            str(tmp_path / "cold_ref")
    r = _run(_train_cmd(str(tmp_path / "ref"),
                        ref_args + ["--checkpoint",
                                    str(tmp_path / "ref.npz")]))
    assert r.returncode == 0, r.stderr[-2000:]

    r = _run(_train_cmd(str(tmp_path / "snap"), place_args), plan=plan)
    assert r.returncode == -9, (r.returncode, r.stderr[-2000:])

    snaps = sorted(p.name for p in (tmp_path / "snap").iterdir())
    if case == "sparse_mid_snapshot":
        assert "snap-00000008.tmp" in snaps and "snap-00000008" not in snaps

    r = _run(_train_cmd(str(tmp_path / "snap"),
                        place_args + ["--resume", "--checkpoint",
                                      str(tmp_path / "resumed.npz")]))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed from snapshot step" in r.stdout
    if case == "sparse_mid_snapshot":
        assert "resumed from snapshot step 4" in r.stdout

    ref = _params_of(tmp_path / "ref.npz")
    got = _params_of(tmp_path / "resumed.npz")
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)


def test_torch_resume_without_snapshots_starts_fresh(tmp_path):
    r = _run(_train_cmd(str(tmp_path / "empty"),
                        ["--placement", "sparse", "--resume"]))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "starting fresh" in r.stdout


def test_torch_snapshot_flags_validated(tmp_path):
    base = [sys.executable, "-m", "repro_torch.launch.train", "--task",
            "ctr", "--device", "cpu", "--samples", "512", "--batch", "64",
            "--base-batch", "64"]
    r = _run(base + ["--epochs", "1", "--snapshot-dir",
                     str(tmp_path / "x")])
    assert r.returncode != 0
    assert "--mode stream" in r.stderr
    r = _run(base + ["--resume"])
    assert r.returncode != 0
    assert "--snapshot-dir" in r.stderr
    r = _run(base + ["--mode", "stream", "--steps", "2", "--snapshot-dir",
                     str(tmp_path / "x")])
    assert r.returncode != 0
    assert "--snapshot-every" in r.stderr
    r = _run(base + ["--mode", "stream", "--steps", "2", "--placement",
                     "hotcold", "--cold-store", "mem", "--nonfinite-guard"])
    assert r.returncode != 0
    assert "not supported for the async hotcold placement" in r.stderr
