"""Crash-safe snapshots, exact resume and streaming on the port's sharded
placements.

* On one spawned 2x2 gloo world (this file run as each rank's program:
  ``python tests/test_torch_sharded_snapshot.py RANK WORLD STORE DIR``;
  torch and the port only), ``sharded`` and ``sharded_sparse``, div and
  mod, online through ``train_ctr(mode="stream")`` with a snapshot every
  4 of 8 steps (rank 0 writes): a run stopped after its step-4 snapshot
  and resumed from it in a fresh bundle equals the uninterrupted run with
  the same cadence, bitwise on every rank (params, moments,
  ``last_step``, the tower's state, the step counter, the losses).
* The state a snapshot writes is the JAX package's sharded state layout:
  the keys, dtypes and padded logical shapes of its state tree for the
  same plans (``pad_embed_tree`` of the m and v trees, ``last_step``
  ``[padded]``), and its values the ranks' blocks put back in logical
  order. A grid of another padded size refuses it with the overlay's
  shape ``ValueError``.
* On a gloo world of one rank: a port snapshot of ``sharded`` resumes in
  the JAX package's 1x1 sharded bundle, and a JAX one in the port, one
  step on within rtol 1e-5 and an atol of 1e-6 of each leaf's largest
  magnitude. JAX's ``sharded_sparse`` step does not build on jax 0.9.0
  (``shard_map`` has no ``check_rep``), so for it the keys, dtypes and
  shapes are compared only.
* The CLI on 4 gloo CPU ranks (``--host-devices 4 --mesh 2,2 --mode
  stream --steps 12 --snapshot-every 4``) SIGKILLed by a ``FaultPlan``
  and restarted with ``--resume``: the checkpoint bitwise equal to the
  uninterrupted run's. The parent exits 137 (128 + SIGKILL), and no
  process of its group outlives it.
"""

import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from test_torch_sharded_guard import (BATCH, HP_KW, VOCABS,  # noqa: F401
                                      _cfg_kw, _close, launch_world,
                                      world1)

REPO = Path(__file__).resolve().parents[1]
CASES = (("sharded", "div"), ("sharded", "mod"), ("sharded_sparse", "div"),
         ("sharded_sparse", "mod"))
STEPS, EVERY, CHUNK = 8, 4, 2
CLI_TIMEOUT = 120


def _dataset():
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.data import make_ctr_dataset

    return make_ctr_dataset(40 * BATCH, VOCABS, n_dense=3, seed=3)


# ---------------------------------------------------------------------------
# a rank of the 2x2 world (run as a script: torch and the port only)
# ---------------------------------------------------------------------------


def rank_main(rank, world, store, workdir):
    import torch

    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.core.scaling import scale_hyperparams
    from repro_torch.core.tree import flatten_with_paths, tree_map
    from repro_torch.data import stream as stream_lib
    from repro_torch.embed import store_for
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import ctr
    from repro_torch.train import snapshot as snap_lib
    from repro_torch.train import train_ctr
    from repro_torch.train.checkpoint import params_from_numpy

    torch.set_num_threads(1)
    hp = scale_hyperparams("cowclip", **HP_KW)
    ds = _dataset()
    out = {}
    with mesh_lib.process_group("cpu", rank=rank, world_size=world,
                                store_path=store):
        grid = mesh_lib.make_ctr_mesh(2, 2, device_type="cpu")
        out["model_rank"] = np.array(grid.model_rank)
        params0 = params_from_numpy(os.path.join(workdir, "params0.npz"),
                                    "cpu")
        for placement, scheme in CASES:
            tag = f"{placement}.{scheme}"
            cfg = ctr.CTRConfig(**_cfg_kw(placement))
            st = store_for(cfg, mesh=grid, partition=scheme)
            token = snap_lib.placement_token(st)

            def run(d, max_steps, start=0, init_state=None, bundle=None):
                bundle = bundle or st.make_bundle(cfg, hp, warmup_steps=0)
                mgr = snap_lib.SnapshotManager(d)
                last = [start]

                def cb(p, s, n):
                    if n - last[0] >= EVERY:
                        p, s = snap_lib.capture(
                            mgr, bundle, p, s, step=n,
                            cursor={"rows_consumed": n * BATCH},
                            meta={"placement": token}, write=rank == 0)
                        last[0] = n
                        if n == EVERY and d.endswith("whole"):
                            # the blocks behind the step-4 snapshot
                            for k, x in flatten_with_paths(s).items():
                                out[f"{tag}/blocks/{k}"] = x.numpy().copy()
                    return p, s

                if init_state is None:
                    p = bundle.prepare(tree_map(torch.clone, params0))
                    init_state = (p, bundle.init(p))
                events = stream_lib.synthetic_event_stream(
                    ds, rows_per_event=BATCH // 2, seed=1)
                if start:
                    events = stream_lib.skip_rows(events, start * BATCH)
                res = train_ctr(
                    cfg, None, ds, None, batch_size=BATCH,
                    step_bundle=bundle, max_steps=max_steps, engine="scan",
                    mode="stream", stream=stream_lib.stream_chunks(
                        events, BATCH, CHUNK, start_rows=start * BATCH),
                    init_state=init_state, start_step=start,
                    snapshot_cb=cb, device="cpu")
                return bundle, res

            d = os.path.join(workdir, tag)
            _, whole = run(d + ".whole", STEPS)
            run(d + ".cut", EVERY)
            # rank 0 may still be writing the step-4 snapshot: a new
            # process would start after it, this one waits for it
            torch.distributed.barrier()
            fresh = st.make_bundle(cfg, hp, warmup_steps=0)
            p, s, start, cursor = snap_lib.resume(
                snap_lib.SnapshotManager(d + ".cut"), fresh,
                ctr.init(cfg, seed=9, device="cpu"), token=token)
            assert start == EVERY and cursor["rows_consumed"] == EVERY * BATCH
            _, resumed = run(d + ".cut", STEPS, start=start,
                             init_state=(p, s), bundle=fresh)
            a = flatten_with_paths((whole.params, whole.opt_state))
            b = flatten_with_paths((resumed.params, resumed.opt_state))
            out[f"{tag}/differ"] = np.array(" ".join(
                k for k in a if not torch.equal(a[k], b[k])))
            out[f"{tag}/losses"] = np.array(
                whole.losses[EVERY:] == resumed.losses)
            out[f"{tag}/steps"] = np.array([whole.steps, resumed.steps])
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _jax_state_shapes(placement, n_shards, scheme):
    """``{key: (shape, dtype)}`` of the JAX package's sharded state tree
    for these plans, built as its ``make_sharded*_train_step`` init
    builds it (``pad_embed_tree`` of the logical tables, ``last_step``
    ``[padded]`` int32 for ``sharded_sparse``)."""
    import jax
    import jax.numpy as jnp

    from repro.core import builders as jax_builders
    from repro.core import scale_hyperparams
    from repro.embed import sharded as jax_shard
    from repro.models import ctr as jax_ctr
    from repro.train.checkpoint import _flatten_with_paths

    cfg = jax_ctr.CTRConfig(**_cfg_kw(placement))
    params = jax_ctr.init(jax.random.key(0), cfg)
    embed = jax_shard.pad_embed_tree(
        params["embed"], jax_shard.make_plans(VOCABS, n_shards, scheme))
    state = {"step": jnp.zeros((), jnp.int32),
             "m": jax.tree.map(jnp.zeros_like, embed),
             "v": jax.tree.map(jnp.zeros_like, embed),
             "dense": jax_builders.dense_tower_tx(
                 scale_hyperparams("cowclip", **HP_KW)).init(
                     params["dense"])}
    if placement == "sharded_sparse":
        state["last_step"] = jax.tree.map(
            lambda w: jnp.zeros((w.shape[0],), jnp.int32), embed)
    return {k: (tuple(np.shape(v)), np.asarray(v).dtype)
            for k, v in _flatten_with_paths(state).items()}


def test_torch_sharded_stream_resume_and_state_format_2x2(tmp_path):
    """The 2x2 world's runs (``rank_main``): resumed == uninterrupted on
    every rank, bitwise; each snapshot's state in JAX's padded logical
    layout, equal to the ranks' blocks in logical order; and the same
    snapshot refused by a grid of another padded size."""
    import jax

    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.core.scaling import scale_hyperparams
    from repro_torch.core.tree import flatten_with_paths
    from repro_torch.embed import sharded as shard_lib
    from repro_torch.embed import store_for
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import ctr
    from repro_torch.train import snapshot as snap_lib

    from repro.models import ctr as jax_ctr

    params0 = jax_ctr.init(jax.random.key(0),
                           jax_ctr.CTRConfig(**_cfg_kw(None)))
    np.savez(tmp_path / "params0.npz", **{
        k: np.asarray(v) for k, v in flatten_with_paths(
            jax.tree.map(np.asarray, params0)).items()})
    ranks = launch_world(__file__, 4, str(tmp_path))

    for placement, scheme in CASES:
        tag = f"{placement}.{scheme}"
        for r, rec in enumerate(ranks):
            assert str(rec[f"{tag}/differ"]) == "", \
                f"{tag} rank {r}: resumed differs at {rec[f'{tag}/differ']}"
            assert bool(rec[f"{tag}/losses"]), f"{tag} rank {r}: losses"
            assert rec[f"{tag}/steps"].tolist() == [STEPS, STEPS]
        mgr = snap_lib.SnapshotManager(str(tmp_path / f"{tag}.whole"))
        assert mgr.list_steps() == [EVERY, STEPS]
        path = str(tmp_path / f"{tag}.whole" / f"snap-{EVERY:08d}")
        assert mgr.validate(path)
        saved = mgr.load_arrays(path, "state")
        want = _jax_state_shapes(placement, 2, scheme)
        assert {k: (v.shape, v.dtype) for k, v in saved.items()} == want
        plans = shard_lib.make_plans(VOCABS, 2, scheme)
        for k, x in saved.items():
            field = k.split("/")[-1]
            for r, rec in enumerate(ranks):
                block = rec[f"{tag}/blocks/{k}"]
                if k.split("/")[0] in ("m", "v", "last_step"):
                    rows = plans[field].shard_rows(int(rec["model_rank"]))
                    np.testing.assert_array_equal(
                        x[rows], block, err_msg=f"{tag} rank {r}: {k}")
                    pad = np.arange(x.shape[0]) >= plans[field].vocab
                    if not k.startswith("last_step"):   # a flush stamps it
                        assert not x[pad].any(), f"{tag}: {k} pad rows"
                else:
                    np.testing.assert_array_equal(x, block,
                                                  err_msg=f"{tag}: {k}")

    # a world of one rank pads nothing: the 2-shard snapshot is refused
    hp = scale_hyperparams("cowclip", **HP_KW)
    with mesh_lib.process_group("cpu"):
        grid = mesh_lib.make_ctr_mesh(1, 1, device_type="cpu")
        for placement in ("sharded", "sharded_sparse"):
            cfg = ctr.CTRConfig(**_cfg_kw(placement))
            st = store_for(cfg, mesh=grid)
            with pytest.raises(ValueError, match=r"snapshot state shape "
                               r"\(58, 4\) != template \(57, 4\)"):
                snap_lib.resume(
                    snap_lib.SnapshotManager(
                        str(tmp_path / f"{placement}.div.whole")),
                    st.make_bundle(cfg, hp, warmup_steps=0),
                    ctr.init(cfg, seed=1, device="cpu"),
                    token=snap_lib.placement_token(st))


def _batches(n, seed=2):
    rng = np.random.default_rng(seed)
    return [{"ids": np.stack([rng.integers(0, v, BATCH) for v in VOCABS],
                             axis=1).astype(np.int32),
             "dense": rng.normal(size=(BATCH, 3)).astype(np.float32),
             "labels": (rng.random(BATCH) < 0.3).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_torch_sharded_snapshot_interchanges_with_jax_1x1(world1, tmp_path,
                                                          direction):
    """A 1x1 ``sharded`` snapshot after 2 steps, written by one package
    and resumed by the other, then one step on each side from the same
    snapshot: params and state within the scaled bar."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.core import build_train_step as jax_build_train_step
    from repro.core import scale_hyperparams as jax_scale_hyperparams
    from repro.embed.store import store_for as jax_store_for
    from repro.models import ctr as jax_ctr
    from repro.train import snapshot as jax_snap
    from repro_torch.core.scaling import scale_hyperparams
    from repro_torch.core.tree import flatten_with_paths, tree_map
    from repro_torch.embed import store_for
    from repro_torch.models import ctr
    from repro_torch.train import snapshot as snap_lib
    from repro_torch.train.checkpoint import params_from_numpy

    cfg_j = jax_ctr.CTRConfig(**_cfg_kw("sharded"))
    cfg_t = ctr.CTRConfig(**_cfg_kw("sharded"))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jstore = jax_store_for(cfg_j, path="sharded", mesh=mesh)
    jbundle = jax_build_train_step(
        cfg_j, jax_scale_hyperparams("cowclip", **HP_KW), path="sharded",
        mesh=mesh, warmup_steps=0)
    tstore = store_for(cfg_t, mesh=world1)
    tbundle = tstore.make_bundle(cfg_t, scale_hyperparams("cowclip",
                                                          **HP_KW),
                                 warmup_steps=0)
    assert snap_lib.placement_token(tstore) == jax_snap.placement_token(
        jstore)
    token = snap_lib.placement_token(tstore)
    jparams0 = jax_ctr.init(jax.random.key(0), cfg_j)
    p_np = jax.tree.map(np.asarray, jparams0)
    bs = _batches(3)
    d = str(tmp_path)
    meta = {"placement": token}
    if direction == "port_to_jax":
        p = tbundle.prepare(params_from_numpy(p_np, "cpu"))
        s = tbundle.init(p)
        for b in bs[:2]:
            p, s, _ = tbundle.step(p, s, tree_map(torch.from_numpy, b))
        snap_lib.capture(snap_lib.SnapshotManager(d), tbundle, p, s, step=2,
                         cursor={"rows_consumed": 2 * BATCH}, meta=meta)
    else:
        jp = jbundle.prepare(jax.tree.map(jnp.asarray, p_np))
        js = jbundle.init(jp)
        for b in bs[:2]:
            jp, js, _ = jbundle.step(jp, js, jax.tree.map(jnp.asarray, b))
        jax_snap.capture(jax_snap.SnapshotManager(d), jbundle, jp, js,
                         step=2, cursor={"rows_consumed": 2 * BATCH},
                         meta=meta)
    jp, js, jstep, _ = jax_snap.resume(
        jax_snap.SnapshotManager(d), jbundle,
        jax.tree.map(jnp.asarray, p_np), token=token)
    tp, ts, tstep, _ = snap_lib.resume(
        snap_lib.SnapshotManager(d), tbundle, params_from_numpy(p_np, "cpu"),
        token=token)
    assert jstep == tstep == 2 and int(ts["step"]) == int(js["step"]) == 2
    jp, js, _ = jbundle.step(jp, js, jax.tree.map(jnp.asarray, bs[2]))
    tp, ts, _ = tbundle.step(tp, ts, tree_map(torch.from_numpy, bs[2]))
    flat = lambda t: {k: np.asarray(v) for k, v in  # noqa: E731
                      flatten_with_paths(t).items()}
    _close(flat(tbundle.export(tp)),
           flat(jax.tree.map(np.asarray, jbundle.export(jp))), "params")
    _close(flat({k: ts[k] for k in ("m", "v", "dense")}),
           flat(jax.tree.map(np.asarray,
                             {k: js[k] for k in ("m", "v", "dense")})),
           "state")


def test_torch_sharded_sparse_snapshot_layout_1x1_matches_jax(world1,
                                                              tmp_path):
    """``sharded_sparse`` at 1x1: the snapshot's state keys, dtypes and
    shapes are JAX's (its step does not build on jax 0.9.0), and it
    resumes bitwise in the port."""
    import torch

    from repro_torch.core.scaling import scale_hyperparams
    from repro_torch.core.tree import flatten_with_paths, tree_map
    from repro_torch.embed import store_for
    from repro_torch.models import ctr
    from repro_torch.train import snapshot as snap_lib

    cfg = ctr.CTRConfig(**_cfg_kw("sharded_sparse"))
    st = store_for(cfg, mesh=world1, partition="mod")
    hp = scale_hyperparams("cowclip", **HP_KW)
    bundle = st.make_bundle(cfg, hp, warmup_steps=0)
    params0 = ctr.init(cfg, seed=1, device="cpu")
    p = bundle.prepare(tree_map(torch.clone, params0))
    s = bundle.init(p)
    bs = [tree_map(torch.from_numpy, b) for b in _batches(4)]
    for b in bs[:2]:
        p, s, _ = bundle.step(p, s, b)
    mgr = snap_lib.SnapshotManager(str(tmp_path))
    p, s = snap_lib.capture(mgr, bundle, p, s, step=2,
                            cursor={"rows_consumed": 2 * BATCH},
                            meta={"placement": snap_lib.placement_token(st)})
    saved = mgr.load_arrays(mgr.latest_valid()[1], "state")
    assert {k: (v.shape, v.dtype) for k, v in saved.items()} == \
        _jax_state_shapes("sharded_sparse", 1, "mod")
    fresh = st.make_bundle(cfg, hp, warmup_steps=0)
    rp, rs, step, _ = snap_lib.resume(mgr, fresh,
                                      ctr.init(cfg, seed=5, device="cpu"),
                                      token=snap_lib.placement_token(st))
    assert step == 2
    for b in bs[2:]:
        p, s, _ = bundle.step(p, s, b)
        rp, rs, _ = fresh.step(rp, rs, b)
    a, b = flatten_with_paths((p, s)), flatten_with_paths((rp, rs))
    assert [k for k in a if not torch.equal(a[k], b[k])] == []


# ---------------------------------------------------------------------------
# the CLI on 4 gloo CPU ranks, SIGKILLed and resumed
# ---------------------------------------------------------------------------


def _cli(snap_dir, extra):
    return [sys.executable, "-m", "repro_torch.launch.train", "--task",
            "ctr", "--device", "cpu", "--host-devices", "4", "--mesh", "2,2",
            "--mode", "stream", "--steps", "12", "--samples", "2048",
            "--batch", "128", "--base-batch", "128", "--mlp-dim", "32",
            "--engine", "scan", "--scan-steps", "2", "--snapshot-every", "4",
            "--snapshot-dir", snap_dir] + extra


def _group_members(pgid):
    """The processes of process group ``pgid`` still alive."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            if os.getpgid(int(entry)) == pgid:
                with open(f"/proc/{entry}/cmdline", "rb") as f:
                    out.append(f.read().replace(b"\0", b" ").decode()[:200])
        except (OSError, ProcessLookupError):
            continue
    return out


def _start_cli(cmd, plan=None):
    """Start the CLI in a process group of its own."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("REPRO_FAULT_PLAN", None)
    if plan is not None:
        env.update(plan.to_env())
    return subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def _finish_cli(proc):
    """Wait for a started CLI, CLI_TIMEOUT seconds at most (then its whole
    group is killed and the test fails with its stderr); after it exits,
    no process of its group may be left (the multiprocessing resource
    tracker gets 5 s to see its pipe close). Returns ``(exit code,
    stdout, stderr)``."""
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"{proc.args} not ended in {CLI_TIMEOUT} s; stderr:\n"
                    + err[-3000:])
    deadline = time.monotonic() + 5
    left = _group_members(proc.pid)
    while left and time.monotonic() < deadline:
        time.sleep(0.1)
        left = _group_members(proc.pid)
    if left:
        os.killpg(proc.pid, signal.SIGKILL)
        pytest.fail(f"processes outlived the CLI (exit {proc.returncode}): "
                    f"{left}")
    return proc.returncode, out, err


def _params_of(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files if k.startswith("params/")}


@pytest.mark.parametrize("case, place_args, plan_kw", [
    # a kill at a chunk boundary between snapshots, on every rank
    ("sharded_boundary", ["--placement", "sharded"],
     dict(kill_at_step=6)),
    # a kill inside rank 0's step-8 snapshot write: a torn .tmp is left,
    # the other ranks are ended by the parent, resume starts at step 4
    ("sharded_sparse_mod_mid_snapshot",
     ["--placement", "sharded_sparse", "--partition", "mod"],
     dict(kill_at_step=8, kill_in_snapshot=True)),
    # the guard on, a kill at step 10
    ("sharded_sparse_guard",
     ["--placement", "sharded_sparse", "--nonfinite-guard"],
     dict(kill_at_step=10)),
])
def test_torch_sharded_cli_sigkill_resume_bitwise(tmp_path, case,
                                                  place_args, plan_kw):
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.testing import FaultPlan

    # the uninterrupted run and the killed one side by side
    ref = _start_cli(_cli(str(tmp_path / "ref"), place_args + [
        "--checkpoint", str(tmp_path / "ref.npz")]))
    killed = _start_cli(_cli(str(tmp_path / "snap"), place_args),
                        plan=FaultPlan(**plan_kw))
    rc, out, err = _finish_cli(ref)
    assert rc == 0, err[-3000:]
    assert out.count("[train] done: 12 steps") == 1, out

    rc, out, err = _finish_cli(killed)
    assert rc == 128 + signal.SIGKILL, (rc, err[-3000:])
    # at a step boundary every rank kills itself, and the parent names the
    # lowest one that died of it before being ended; inside the snapshot
    # write only rank 0 does
    killer = "0" if plan_kw.get("kill_in_snapshot") else "[0-3]"
    assert re.search(f"rank {killer} of 4 was killed by SIGKILL", err), \
        err[-3000:]
    snaps = sorted(p.name for p in (tmp_path / "snap").iterdir())
    if plan_kw.get("kill_in_snapshot"):
        assert "snap-00000008.tmp" in snaps and "snap-00000008" not in snaps

    rc, out, err = _finish_cli(_start_cli(_cli(
        str(tmp_path / "snap"), place_args + [
            "--resume", "--checkpoint", str(tmp_path / "resumed.npz")])))
    assert rc == 0, err[-3000:]
    start = {"sharded_boundary": 4, "sharded_sparse_mod_mid_snapshot": 4,
             "sharded_sparse_guard": 8}[case]
    assert out.count(f"resumed from snapshot step {start} ") == 1, out
    ref = _params_of(tmp_path / "ref.npz")
    got = _params_of(tmp_path / "resumed.npz")
    assert set(ref) == set(got) and ref
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
