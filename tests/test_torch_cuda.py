"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, and the fused and sparse train steps on the card against the CPU
path.

They carry the ``cuda`` marker and skip without a CUDA device. This file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed (the card's machine); there, skip the repo's conftest,
which imports JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.scaling import scale_hyperparams
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import iterate_batches, make_ctr_dataset
from repro_torch.embed import store_for
from repro_torch.kernels.cowclip import (fused_cowclip_adam, reference,
                                         sparse_gather_catchup,
                                         sparse_update_scatter)
from repro_torch.kernels.cowclip import ref as cc_ref
from repro_torch.models import ctr


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _inputs(vocab, dim, seed):
    rng = np.random.default_rng(seed)
    arrays = [
        (0.01 * rng.standard_normal((vocab, dim))).astype(np.float32),
        (0.1 * rng.standard_normal((vocab, dim))).astype(np.float32),
        (rng.integers(0, 4, (vocab,)) * (rng.random(vocab) < 0.5)
         ).astype(np.float32),
        (0.01 * rng.standard_normal((vocab, dim))).astype(np.float32),
        (0.001 * np.abs(rng.standard_normal((vocab, dim)))).astype(np.float32),
    ]
    return [torch.from_numpy(a).cuda() for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("vocab,dim", [(4, 10), (1000, 10), (1000, 1),
                                       (333, 33), (100, 4096)])
@pytest.mark.parametrize("step", [1, 1000])
def test_torch_cowclip_cuda_kernel_matches_plain(vocab, dim, step):
    """rtol 1e-5 / atol 1e-7: the JAX kernel's bar against its reference."""
    _need_cuda()
    w, g, cnt, m, v = _inputs(vocab, dim, seed=vocab * dim + step)
    ref = reference(w, g, cnt, m, v, step)
    before = fused_cowclip_adam.launches
    out = fused_cowclip_adam(w, g, cnt, m, v, step)
    torch.cuda.synchronize()
    assert fused_cowclip_adam.launches == before + 1
    assert out[0] is w and out[1] is m and out[2] is v
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_torch_cowclip_cuda_rejects_mixed_devices():
    _need_cuda()
    w, g, cnt, m, v = _inputs(8, 4, seed=0)
    with pytest.raises(ValueError):
        fused_cowclip_adam(w, g.cpu(), cnt, m, v, 1)


@pytest.mark.cuda
def test_torch_fused_step_cuda_matches_cpu():
    """Three fused steps on the card against the CPU path (which the CPU
    tests hold to the JAX package), rtol 1e-5 / atol 1e-5; the kernel
    launches once per table per step."""
    _need_cuda()
    cfg = ctr.CTRConfig(name="deepfm", vocab_sizes=(2000, 700, 120, 30, 5),
                        n_dense=4, emb_dim=8, mlp_dims=(32, 32, 32),
                        emb_sigma=1e-2, placement="fused")
    hp = scale_hyperparams("cowclip", base_lr=1e-3, base_l2=1e-5,
                           base_batch=256, batch_size=512, base_dense_lr=2e-3)
    ds = make_ctr_dataset(3 * 512, cfg.vocab_sizes, n_dense=4, seed=1)
    params0 = ctr.init(cfg, seed=1, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        bundle = store_for(cfg).make_bundle(cfg, hp, warmup_steps=2)
        params = tree_map(lambda t: t.clone().to(dev), params0)
        state = bundle.init(params)
        before = fused_cowclip_adam.launches
        for b in iterate_batches(ds, 512, seed=0):
            params, state, _ = bundle.step(
                params, state,
                {k: torch.as_tensor(x, device=dev) for k, x in b.items()})
        launched = fused_cowclip_adam.launches - before
        assert launched == (0 if dev == "cpu" else 3 * 2 * cfg.n_fields)
        out[dev] = [t.cpu() for t in tree_leaves(params)]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _sparse_case(rows, dim, cap, n_ids, step, seed, off=0, vocab=None):
    """A table shard ``[off, off + rows)`` of a ``vocab``-id table on the
    card, ``last_step`` up to ``step - 1`` behind, and ``cap`` slots: the
    distinct uids of ``n_ids`` draws, padded with ``vocab``."""
    rng = np.random.default_rng(seed)
    vocab = rows + off if vocab is None else vocab
    ids = rng.integers(off, min(off + rows, vocab), size=n_ids)
    uids, counts = np.unique(ids, return_counts=True)
    uids, counts = uids[:cap], counts[:cap]
    pad = cap - uids.shape[0]
    arrays = dict(
        w=(0.01 * rng.standard_normal((rows, dim))).astype(np.float32),
        m=(0.01 * rng.standard_normal((rows, dim))).astype(np.float32),
        v=(0.001 * np.abs(rng.standard_normal((rows, dim)))
           ).astype(np.float32),
        ls=rng.integers(0, step, size=rows).astype(np.int32),
        uids=np.concatenate([uids, np.full(pad, vocab)]).astype(np.int32),
        counts=np.concatenate([counts, np.zeros(pad)]).astype(np.float32),
        g=(0.1 * rng.standard_normal((cap, dim))).astype(np.float32),
    )
    return {k: torch.from_numpy(a).cuda() for k, a in arrays.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("rows,dim,cap,off,vocab", [
    (50, 8, 12, 0, None),
    (1000, 10, 512, 0, None),
    (1000, 1, 512, 0, None),     # the CowClip-exempt LR stream
    (400, 33, 64, 0, None),      # dim above a warp
    (300, 10, 160, 100, 380),    # a shard: pad uids land in its range
])
@pytest.mark.parametrize("step", [1, 1000])
def test_torch_sparse_cuda_kernels_match_plain(rows, dim, cap, off, vocab,
                                               step):
    """Catch-up rows on the real slots (pads finite), then the full tables
    and ``last_step`` after the update; rtol 1e-5 / atol 1e-7."""
    _need_cuda()
    c = _sparse_case(rows, dim, cap, cap - 4, step, seed=rows + dim + step,
                     off=off, vocab=vocab)
    kw = dict(lr=1e-3, l2=1e-4, row_offset=off)
    real = c["counts"] > 0
    assert bool(real.any()) and not bool(real.all())
    before = (sparse_gather_catchup.launches, sparse_update_scatter.launches)
    got = sparse_gather_catchup(c["w"], c["m"], c["v"], c["ls"], c["uids"],
                                c["counts"], step, **kw)
    want = cc_ref.sparse_gather_catchup_reference(
        c["w"], c["m"], c["v"], c["ls"], c["uids"], step, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a[real], b[real], rtol=1e-5, atol=1e-7)

    tables = [c[k].clone() for k in ("w", "m", "v", "ls")]
    out = sparse_update_scatter(*tables, c["uids"], c["counts"], got[0],
                                c["g"], got[1], got[2], step, **kw)
    want = cc_ref.sparse_update_scatter_reference(
        *(c[k] for k in ("w", "m", "v", "ls")), c["uids"], c["counts"],
        got[0], c["g"], got[1], got[2], step, **kw)
    torch.cuda.synchronize()
    assert all(a is b for a, b in zip(out, tables))
    for a, b in zip(out[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    assert torch.equal(out[3], want[3])
    assert (sparse_gather_catchup.launches, sparse_update_scatter.launches) \
        == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_torch_sparse_cuda_rejects_mixed_devices():
    _need_cuda()
    c = _sparse_case(64, 4, 8, 6, 3, seed=0)
    with pytest.raises(ValueError):
        sparse_gather_catchup(c["w"], c["m"], c["v"], c["ls"].cpu(),
                              c["uids"], c["counts"], 3)
    rows = torch.zeros(8, 4, device="cuda")
    with pytest.raises(ValueError):
        sparse_update_scatter(c["w"], c["m"], c["v"], c["ls"], c["uids"],
                              c["counts"], rows, c["g"].cpu(), rows, rows, 3)


@pytest.mark.cuda
def test_torch_sparse_step_cuda_matches_cpu_and_repeats_bitwise():
    """Three sparse steps on the card against the CPU path, rtol 1e-5 /
    atol 1e-5; the same steps again on the card are bitwise equal (the row
    gradient is a sorted segment sum, no atomics); each sparse kernel
    launches once per table per step, the fused one never."""
    _need_cuda()
    cfg = ctr.CTRConfig(name="deepfm", vocab_sizes=(2000, 700, 120, 30, 5),
                        n_dense=4, emb_dim=8, mlp_dims=(32, 32, 32),
                        emb_sigma=1e-2, placement="sparse")
    hp = scale_hyperparams("cowclip", base_lr=1e-3, base_l2=1e-3,
                           base_batch=256, batch_size=512, base_dense_lr=2e-3)
    ds = make_ctr_dataset(3 * 512, cfg.vocab_sizes, n_dense=4, seed=1)
    params0 = ctr.init(cfg, seed=1, device="cpu")
    out = {}
    for run, dev in (("cpu", "cpu"), ("cuda", "cuda"), ("cuda2", "cuda")):
        bundle = store_for(cfg).make_bundle(cfg, hp, warmup_steps=2)
        params = tree_map(lambda t: t.clone().to(dev), params0)
        state = bundle.init(params)
        before = (fused_cowclip_adam.launches, sparse_gather_catchup.launches,
                  sparse_update_scatter.launches)
        for b in iterate_batches(ds, 512, seed=0):
            params, state, _ = bundle.step(
                params, state,
                {k: torch.as_tensor(x, device=dev) for k, x in b.items()})
        params, state = bundle.flush(params, state)
        after = (fused_cowclip_adam.launches, sparse_gather_catchup.launches,
                 sparse_update_scatter.launches)
        n = 0 if dev == "cpu" else 3 * 2 * cfg.n_fields
        assert tuple(a - b for a, b in zip(after, before)) == (0, n, n)
        out[run] = [t.cpu() for t in tree_leaves(params)]
    for a, b, c in zip(out["cuda"], out["cpu"], out["cuda2"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        assert torch.equal(a, c)
