"""The non-finite guard on the port's sharded placements.

* On a gloo world of one rank, in process: ``sharded`` (div and mod)
  under the guard over 4 batches whose second holds a NaN dense cell,
  against the JAX package's ``guard_bundle`` around its
  ``build_train_step(path="sharded")`` on a 1x1 mesh: params and state
  after each step within rtol 1e-5 and an atol of 1e-6 of each leaf's
  largest magnitude, and ``skipped_steps`` equal.
* On one spawned 2x2 gloo world (this file run as each rank's program:
  ``python tests/test_torch_sharded_guard.py RANK WORLD STORE DIR``; torch
  and the port only, no JAX), div and mod, ``sharded``, ``sharded_sparse``
  and ``sharded_sparse`` with a capped capacity that overflows on the
  poisoned step: the exported params after each of the 4 batches against
  JAX's guarded substrate (``guard_bundle`` around the substrate bundle)
  at the same bar, every rank's export bitwise equal, ``skipped_steps``
  [0, 1, 0, 0] on every rank. Within the port, bitwise on every rank:
  guarded == unguarded over 4 clean batches; guarded over ``[b1, NaN, b3,
  b4]`` == unguarded over ``[b1, b3, b4]`` (params, moments,
  ``last_step``, the tower's state and the step counter); the scan
  engine's chunk == the eager guarded steps.

``base_l2`` is 1.0, so a step's decay moves a row far past the bar. A
world that has not ended within ``JOIN_TIMEOUT`` seconds is killed, and
the test fails with its ranks' logs.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT = 120
VOCABS = (57, 13, 5)          # every field odd: padded on 2 shards
BATCH = 64
CAPPED = 2
HP_KW = dict(base_lr=1e-3, base_l2=1.0, base_batch=64, batch_size=BATCH,
             base_dense_lr=2e-3)
SCHEMES = ("div", "mod")
# (placement, unique_capacity) of each run on the 2x2 world
RUNS = (("sharded", 0), ("sharded_sparse", 0), ("sharded_sparse", CAPPED))
POISONED = 1                  # the batch with the NaN cell


def _batch(rng, pools):
    ids = np.stack([rng.choice(p, size=BATCH) for p in pools], axis=1)
    return {"ids": ids.astype(np.int32),
            "dense": rng.normal(size=(BATCH, 3)).astype(np.float32),
            "labels": (rng.random(BATCH) < 0.3).astype(np.float32)}


def batches(poisoned=True):
    """4 batches; field 1's 13 ids overflow a capacity of 2 a shard on
    every step (the poisoned one too), and rows skip steps, so forwards
    read rows with pending decay. With ``poisoned``, batch
    ``POISONED`` holds a NaN dense cell."""
    rng = np.random.default_rng(7)
    narrow = [[1, 2, 50], np.arange(13), [0, 4]]
    wide = [np.arange(1, 12).tolist() + [50, 51], np.arange(13), [0, 2, 4]]
    out = [_batch(rng, p) for p in (narrow, wide, narrow, wide)]
    if poisoned:
        out[POISONED]["dense"][3, 1] = np.nan
    return out


def _cfg_kw(placement, capacity=0):
    return dict(name="deepfm", vocab_sizes=VOCABS, n_dense=3, emb_dim=4,
                mlp_dims=(16, 16, 16), emb_sigma=1e-2, placement=placement,
                unique_capacity=capacity)


def _close(got, want, what):
    """Every leaf within rtol 1e-5 and an atol of 1e-6 of the leaf's
    largest magnitude (``test_torch_sharded.py``'s bar)."""
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        w = np.asarray(w)
        atol = 1e-6 * float(np.max(np.abs(w))) if w.size else 0.0
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=1e-5,
                                   atol=atol, err_msg=f"{what}: {k}")


# ---------------------------------------------------------------------------
# a rank of the 2x2 world (run as a script: torch and the port only)
# ---------------------------------------------------------------------------


def rank_main(rank, world, store, workdir):
    import torch

    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.core.scaling import scale_hyperparams
    from repro_torch.core.tree import flatten_with_paths, tree_map
    from repro_torch.embed import store_for
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import ctr
    from repro_torch.train import engine as engine_lib
    from repro_torch.train.checkpoint import params_from_numpy

    torch.set_num_threads(1)
    hp = scale_hyperparams("cowclip", **HP_KW)
    as_t = lambda bs: [{k: torch.from_numpy(v) for k, v in b.items()}  # noqa: E731
                       for b in bs]
    poisoned, clean = as_t(batches()), as_t(batches(poisoned=False))

    def differ(a, b):
        fa, fb = flatten_with_paths(a), flatten_with_paths(b)
        assert fa.keys() == fb.keys()
        return [k for k in fa if not torch.equal(fa[k], fb[k])]

    out = {}
    with mesh_lib.process_group("cpu", rank=rank, world_size=world,
                                store_path=store):
        grid = mesh_lib.make_ctr_mesh(2, 2, device_type="cpu")
        params0 = params_from_numpy(os.path.join(workdir, "params0.npz"),
                                    "cpu")
        for scheme in SCHEMES:
            for placement, cap in RUNS:
                tag = f"{scheme}.{placement}.{cap}"
                cfg = ctr.CTRConfig(**_cfg_kw(placement, cap))
                store = store_for(cfg, mesh=grid, partition=scheme)
                g = store.make_bundle(cfg, hp, warmup_steps=0,
                                      nonfinite_guard=True)
                u = store.make_bundle(cfg, hp, warmup_steps=0)

                def fresh(bundle):
                    p = bundle.prepare(tree_map(torch.clone, params0))
                    return p, bundle.init(p)

                def run(bundle, bs, record=None):
                    p, s = fresh(bundle)
                    for i, b in enumerate(bs):
                        p, s, aux = bundle.step(p, s, b)
                        if record is None:
                            continue
                        pf, _ = bundle.flush(*tree_map(torch.clone, (p, s)))
                        for k, x in flatten_with_paths(
                                bundle.export(pf)).items():
                            out[f"{tag}/{i}/params/{k}"] = x.numpy()
                        for k, x in aux.items():
                            out[f"{tag}/{i}/aux/{k}"] = x.numpy()
                    return p, s

                guarded = run(g, poisoned, record=True)
                removed = run(u, [b for i, b in enumerate(poisoned)
                                  if i != POISONED])
                out[f"{tag}/skip_vs_removed"] = np.array(
                    " ".join(differ(guarded, removed)))
                out[f"{tag}/clean_vs_unguarded"] = np.array(" ".join(
                    differ(run(g, clean), run(u, clean))))
                p, s = fresh(g)
                runner = engine_lib.make_chunk_runner(g.step.scan_step)
                chunk = {k: torch.stack([b[k] for b in poisoned])
                         for k in poisoned[0]}
                p, s, aux = runner(p, s, chunk)
                out[f"{tag}/engine_vs_eager"] = np.array(
                    " ".join(differ(guarded, (p, s))))
                out[f"{tag}/engine_skipped"] = aux["skipped_steps"].numpy()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)


def launch_world(script, n, workdir, timeout=JOIN_TIMEOUT):
    """Start ``n`` ranks running ``script`` (``script RANK N STORE
    WORKDIR``), wait for all of them (``timeout`` in all), and fail with
    every rank's log if one fails or the world hangs. Returns each
    rank's ``rank{r}.npz``."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    store = os.path.join(workdir, "store")
    procs, logs = [], []
    for r in range(n):
        log = open(os.path.join(workdir, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, script, str(r), str(n), store, workdir],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO))
    deadline = time.monotonic() + timeout
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
        pytest.fail((f"not ended in {timeout} s, killed" if hung
                     else f"ranks exited {codes}") + "\n" + tails)
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
            for r in range(n)]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture
def world1():
    """A gloo process group of one rank, destroyed after the test."""
    from repro_torch.launch import mesh as mesh_lib

    with mesh_lib.process_group("cpu"):
        yield mesh_lib.make_ctr_mesh(1, 1, device_type="cpu")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_torch_sharded_guard_1x1_matches_jax_guarded_sharded(world1,
                                                             scheme):
    import jax
    import jax.numpy as jnp
    import torch

    from repro.core import build_train_step as jax_build_train_step
    from repro.core import scale_hyperparams as jax_scale_hyperparams
    from repro.embed.store import guard_bundle
    from repro.models import ctr as jax_ctr
    from repro_torch.core.scaling import scale_hyperparams
    from repro_torch.core.tree import flatten_with_paths, tree_map
    from repro_torch.embed import store_for
    from repro_torch.models import ctr
    from repro_torch.train.checkpoint import params_from_numpy

    cfg_j = jax_ctr.CTRConfig(**_cfg_kw("sharded"))
    cfg_t = ctr.CTRConfig(**_cfg_kw("sharded"))
    jbundle = guard_bundle(jax_build_train_step(
        cfg_j, jax_scale_hyperparams("cowclip", **HP_KW), path="sharded",
        partition=scheme, mesh=jax.make_mesh((1, 1), ("data", "model")),
        warmup_steps=0))
    tbundle = store_for(cfg_t, mesh=world1, partition=scheme).make_bundle(
        cfg_t, scale_hyperparams("cowclip", **HP_KW), warmup_steps=0,
        nonfinite_guard=True)
    params_j = jax_ctr.init(jax.random.key(0), cfg_j)
    params_t = tbundle.prepare(
        params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu"))
    params_j = jbundle.prepare(params_j)
    state_j, state_t = jbundle.init(params_j), tbundle.init(params_t)
    flat = lambda t: {k: np.asarray(v) for k, v in  # noqa: E731
                      flatten_with_paths(t).items()}
    skips = []
    for i, b in enumerate(batches()):
        params_j, state_j, aux_j = jbundle.step(
            params_j, state_j, jax.tree.map(jnp.asarray, b))
        params_t, state_t, aux_t = tbundle.step(
            params_t, state_t, tree_map(torch.from_numpy, b))
        assert int(aux_t["skipped_steps"]) == int(aux_j["skipped_steps"])
        skips.append(int(aux_t["skipped_steps"]))
        _close(flat(tbundle.export(params_t)),
               flat(jax.tree.map(np.asarray, jbundle.export(params_j))),
               f"params after step {i}")
        _close(flat({k: state_t[k] for k in ("m", "v", "dense")}),
               flat(jax.tree.map(np.asarray, {k: state_j[k] for k in
                                              ("m", "v", "dense")})),
               f"state after step {i}")
        assert int(state_t["step"]) == int(state_j["step"])
    assert skips == [0, 1, 0, 0]


def test_torch_sharded_guard_2x2_matches_jax_guarded_substrate(tmp_path):
    """The 2x2 world's runs (``rank_main``) against JAX's guarded
    substrate, and the port's own bitwise claims on every rank."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.core.tree import flatten_with_paths

    from repro.core import scale_hyperparams
    from repro.embed.store import store_for as jax_store_for
    from repro.models import ctr as jax_ctr

    cfg = jax_ctr.CTRConfig(**_cfg_kw(None))
    params0 = jax_ctr.init(jax.random.key(0), cfg)
    np.savez(tmp_path / "params0.npz", **{
        k: np.asarray(v) for k, v in flatten_with_paths(
            jax.tree.map(np.asarray, params0)).items()})
    ranks = launch_world(__file__, 4, str(tmp_path))

    jbundle = jax_store_for(cfg, path="substrate").make_bundle(
        cfg, scale_hyperparams("cowclip", **HP_KW), warmup_steps=0,
        nonfinite_guard=True)
    params, state = params0, jbundle.init(params0)
    want, skips = [], []
    for b in batches():
        params, state, aux = jbundle.step(params, state,
                                          jax.tree.map(jnp.asarray, b))
        want.append(flatten_with_paths(jax.tree.map(np.asarray, params)))
        skips.append(int(aux["skipped_steps"]))
    assert skips == [0, 1, 0, 0]

    for scheme in SCHEMES:
        for placement, cap in RUNS:
            tag = f"{scheme}.{placement}.{cap}"
            for i, w in enumerate(want):
                pre = f"{tag}/{i}/params/"
                got0 = {k[len(pre):]: v for k, v in ranks[0].items()
                        if k.startswith(pre)}
                _close(got0, w, f"{tag} step {i}")
                for r, rec in enumerate(ranks):
                    for k in w:
                        np.testing.assert_array_equal(
                            rec[pre + k], got0[k],
                            err_msg=f"{tag} step {i}: {k} on rank {r}")
                    assert int(rec[f"{tag}/{i}/aux/skipped_steps"]) \
                        == skips[i], f"{tag} step {i} rank {r}"
            if cap:
                # the fallback's select ran on the poisoned step
                assert all(int(rec[f"{tag}/{POISONED}/aux/overflow_shards"])
                           > 0 for rec in ranks), tag
            for r, rec in enumerate(ranks):
                for check in ("skip_vs_removed", "clean_vs_unguarded",
                              "engine_vs_eager"):
                    assert str(rec[f"{tag}/{check}"]) == "", \
                        f"{tag} rank {r} {check}: {rec[f'{tag}/{check}']}"
                assert rec[f"{tag}/engine_skipped"].tolist() == skips, tag


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
