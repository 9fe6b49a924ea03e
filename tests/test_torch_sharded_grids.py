"""The port's sharded placements on multi-rank gloo grids against the JAX
package's single-device substrate step.

Each grid is one world of CPU ranks, spawned as processes that run this
file (``python tests/test_torch_sharded_grids.py RANK WORLD STORE CASE
DIR``; they import torch and the port, never JAX) and rendezvous through a
``FileStore`` in the test's temporary directory (no port number). One
world checks both placements:

* ``sharded`` and ``sharded_sparse`` (default capacity) over 3 batches
  and then a batch whose ids all fall on shard 0;
* ``sharded_sparse`` with ``unique_capacity=2``, over batches that widen
  after the first, so shards overflow mid-run and take the dense
  fallback.

Every rank records, after each step, the exported tables (``sharded_sparse``
flushed on a copy), its dense tower, and the step's aux. The test holds,
per step, the exported params of every rank to JAX's substrate step over
the same batches from the same params within rtol 1e-5 and an atol of
1e-6 of each leaf's largest magnitude (at an L2 large enough that a
step's decay moves a row far past that bar), the dense towers of all
ranks bitwise equal, and ``aux["overflow_shards"]`` to the count of
overflowing shards of JAX's ``shard_unique_sets`` on the same batch. The
grids: 2x4 div and mod (vocab % 4 = 1 for every field), 8x1 div, and 1x2
with an uneven remainder. A world that has not ended within
``JOIN_TIMEOUT`` seconds is killed, and the test fails with its ranks'
stderr. The CLI runs its own world of 4 ranks (``--host-devices 4``),
and one of 2 under ``torchrun``.
"""

import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT = 120
VOCABS = (57, 13, 5)
CAPPED = 2
GRIDS = {
    "2x4_div": (2, 4, "div"),
    "8x1_div": (8, 1, "div"),
    "2x4_mod": (2, 4, "mod"),
    "1x2_uneven": (1, 2, "div"),
}
BATCH = 64


def _batch(rng, pools):
    ids = np.stack([rng.choice(p, size=BATCH) for p in pools], axis=1)
    return {"ids": ids.astype(np.int32),
            "dense": rng.normal(size=(BATCH, 3)).astype(np.float32),
            "labels": (rng.random(BATCH) < 0.3).astype(np.float32)}


def _shard0_ids(vocab, n_shards, scheme):
    """The ids of ``vocab`` that shard 0 owns."""
    if scheme == "div":
        return np.arange(math.ceil(vocab / n_shards))
    return np.arange(0, vocab, n_shards)


def sequences(case):
    """The grid's two batch sequences: ``main`` (3 batches, then one whose
    ids all fall on shard 0) and ``overflow`` (a narrow batch, then 2 that
    widen field 0 past the capped capacity)."""
    _, model, scheme = GRIDS[case]
    rng = np.random.default_rng(5)
    wide = [[1, 2, 3, 20, 33, 50, 51], np.arange(13), [0, 2, 4]]
    main = [_batch(rng, wide) for _ in range(3)]
    main.append(_batch(rng, [_shard0_ids(v, model, scheme) for v in VOCABS]))
    narrow = [[1, 50], np.arange(13), [0, 4]]
    widened = [np.arange(1, 12).tolist() + [50, 51], np.arange(13), [0, 4]]
    overflow = [_batch(rng, narrow)] + [_batch(rng, widened)
                                        for _ in range(2)]
    return {"main": main, "overflow": overflow}


def _cfg_kw(placement, capacity=0):
    return dict(name="deepfm", vocab_sizes=VOCABS, n_dense=3, emb_dim=4,
                mlp_dims=(16, 16, 16), emb_sigma=1e-2, placement=placement,
                unique_capacity=capacity)


# l2 large enough that a step's decay moves a row far past the bar
HP_KW = dict(base_lr=1e-3, base_l2=1.0, base_batch=64, batch_size=BATCH,
             base_dense_lr=2e-3)
RUNS = (("sharded", "main", 0), ("sharded_sparse", "main", 0),
        ("sharded_sparse", "overflow", CAPPED))


# ---------------------------------------------------------------------------
# a rank (run as a script: torch and the port only)
# ---------------------------------------------------------------------------


def rank_main(rank, world, store, case, workdir):
    import torch

    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.core.scaling import scale_hyperparams
    from repro_torch.core.tree import flatten_with_paths, tree_map
    from repro_torch.embed import store_for
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import ctr
    from repro_torch.train.checkpoint import params_from_numpy

    torch.set_num_threads(1)
    data, model, scheme = GRIDS[case]
    seqs = sequences(case)
    hp = scale_hyperparams("cowclip", **HP_KW)
    out = {}
    with mesh_lib.process_group("cpu", rank=rank, world_size=world,
                                store_path=store):
        grid = mesh_lib.make_ctr_mesh(data, model, device_type="cpu")
        params0 = params_from_numpy(os.path.join(workdir, "params0.npz"),
                                    "cpu")
        for placement, seq, cap in RUNS:
            cfg = ctr.CTRConfig(**_cfg_kw(placement, cap))
            bundle = store_for(cfg, mesh=grid, partition=scheme).make_bundle(
                cfg, hp, warmup_steps=0)
            params = bundle.prepare(tree_map(torch.clone, params0))
            state = bundle.init(params)
            for i, b in enumerate(seqs[seq]):
                params, state, aux = bundle.step(
                    params, state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
                p, _ = bundle.flush(*tree_map(torch.clone, (params, state)))
                tag = f"{placement}.{seq}.{i}"
                for k, x in flatten_with_paths(bundle.export(p)).items():
                    out[f"{tag}/params/{k}"] = x.numpy()
                for k, x in aux.items():
                    out[f"{tag}/aux/{k}"] = x.numpy()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# the test
# ---------------------------------------------------------------------------


def _launch_world(case, workdir):
    """Start the grid's ranks, wait for all of them (JOIN_TIMEOUT in all),
    and fail with every rank's stderr if one fails or the world hangs."""
    data, model, _ = GRIDS[case]
    n = data * model
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    store = os.path.join(workdir, "store")
    procs, logs = [], []
    for r in range(n):
        log = open(os.path.join(workdir, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(r), str(n), store, case,
             workdir], env=env, stdout=log, stderr=subprocess.STDOUT,
            cwd=REPO))
    deadline = time.monotonic() + JOIN_TIMEOUT
    hung = False
    try:
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                hung = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if hung or any(codes):
        tails = "\n".join(
            f"--- rank {r} (exit {c}) ---\n"
            + Path(workdir, f"rank{r}.log").read_text()[-3000:]
            for r, c in enumerate(codes))
        pytest.fail(f"grid {case}: "
                    + (f"not ended in {JOIN_TIMEOUT} s, killed"
                       if hung else f"ranks exited {codes}") + "\n" + tails)
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
            for r in range(n)]


@pytest.mark.parametrize("case", list(GRIDS))
def test_torch_sharded_grid_matches_jax_substrate(case, tmp_path):
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.core.tree import flatten_with_paths

    from repro.core import build_optimizer, scale_hyperparams
    from repro.embed.sharded import RowShardPlan
    from repro.embed.sharded_sparse import shard_capacity, shard_unique_sets
    from repro.models import ctr as jax_ctr
    from repro.train.loop import make_train_step

    data, model, scheme = GRIDS[case]
    cfg = jax_ctr.CTRConfig(**_cfg_kw(None))
    hp = scale_hyperparams("cowclip", **HP_KW)
    params0 = jax_ctr.init(jax.random.key(0), cfg)
    np.savez(tmp_path / "params0.npz", **{
        k: np.asarray(v) for k, v in flatten_with_paths(
            jax.tree.map(np.asarray, params0)).items()})
    ranks = _launch_world(case, str(tmp_path))

    tx = build_optimizer(hp, warmup_steps=0)
    step = make_train_step(cfg, tx)
    plans = [RowShardPlan(v, model, scheme) for v in VOCABS]
    checked = 0
    for seq, batches in sequences(case).items():
        params = jax.tree.map(jnp.copy, params0)   # the step donates it
        state = tx.init(params)
        for i, b in enumerate(batches):
            params, state, aux = step(params, state,
                                      jax.tree.map(jnp.asarray, b))
            want = flatten_with_paths(jax.tree.map(np.asarray, params))
            for placement, s, cap in RUNS:
                if s != seq:
                    continue
                tag = f"{placement}.{seq}.{i}"
                got0 = {k.split("/params/", 1)[1]: v
                        for k, v in ranks[0].items()
                        if k.startswith(f"{tag}/params/")}
                assert got0.keys() == want.keys(), tag
                for k in want:
                    # atol scaled to the leaf: 1e-6 of its largest value
                    np.testing.assert_allclose(
                        got0[k], want[k], rtol=1e-5,
                        atol=1e-6 * float(np.max(np.abs(want[k]))),
                        err_msg=f"{case} {tag}: {k}")
                    for r, rec in enumerate(ranks[1:], 1):
                        # replicas of the tower, and every rank's export
                        np.testing.assert_array_equal(
                            rec[f"{tag}/params/{k}"], got0[k],
                            err_msg=f"{case} {tag}: {k} on rank {r}")
                np.testing.assert_allclose(
                    ranks[0][f"{tag}/aux/loss"], float(aux["loss"]),
                    rtol=1e-5, err_msg=f"{case} {tag}: loss")
                if placement == "sharded_sparse":
                    n_over = 0
                    for f, plan in enumerate(plans):
                        c = shard_capacity(plan, BATCH, cap)
                        if c < min(BATCH, plan.rows_per_shard):
                            n_over += int(jnp.sum(shard_unique_sets(
                                jnp.asarray(b["ids"][:, f]), plan,
                                c).overflow))
                    for rec in ranks:
                        assert int(rec[f"{tag}/aux/overflow_shards"]) \
                            == n_over, f"{case} {tag}: overflow"
                checked += 1
    over = sum(int(ranks[0][f"sharded_sparse.overflow.{i}/aux/"
                            "overflow_shards"]) for i in range(3))
    assert over > 0, f"{case}: the capped run never overflowed"
    assert checked == 4 + 4 + 3



def test_torch_sharded_cli_on_host_ranks(tmp_path):
    """The CLI on 4 gloo CPU ranks (``--mesh 2,2 --host-devices 4``):
    exits 0, rank 0 alone prints (the store line and the AUC once), and
    the checkpoint holds whole ``[vocab, D]`` tables (the export)."""
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.train.checkpoint import params_from_numpy

    ckpt = tmp_path / "c.npz"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--task", "ctr",
         "--device", "cpu", "--placement", "sharded_sparse", "--mesh", "2,2",
         "--host-devices", "4", "--samples", "2048", "--batch", "256",
         "--steps", "2", "--checkpoint", str(ckpt)],
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        capture_output=True, text=True, timeout=JOIN_TIMEOUT, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("embedding store sharded_sparse(rows over "
                            "model=2, batch over data=2") == 1, out.stdout
    assert out.stdout.count("[train] done: 2 steps") == 1, out.stdout
    assert "-> AUC " in out.stdout
    params = params_from_numpy(str(ckpt), device="cpu")
    assert params["embed"]["fm"]["field_1"].shape == (80000, 10)
    assert params["embed"]["lin"]["field_4"].shape == (200, 1)



def test_torch_sharded_cli_under_torchrun():
    """The CLI under ``torchrun --standalone`` (2 gloo CPU ranks; the
    rendezvous on a port torchrun picks on localhost): the ranks take
    rank and world from the environment, and rank 0 alone prints."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--placement", "sharded", "--mesh", "1,2",
         "--samples", "2048", "--batch", "256", "--steps", "2"],
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=JOIN_TIMEOUT, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("embedding store sharded(rows over model=2, "
                            "batch over data=1, div partition)") == 1
    assert out.stdout.count("[train] done: 2 steps") == 1, out.stdout


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
              sys.argv[5])
