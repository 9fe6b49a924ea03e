"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version (the Mamba-2 scan's forward and backward among them), the
substrate, fused and sparse train steps on the card against
the CPU path, the hot/cold step's graphs against its eager steps and its
async cold store against it, the RWKV-6 LM's forward, prefill and decode on the card against
the CPU path, the attention LM's decode graph across a ring's wrap,
zamba2's and granite-moe's decode graphs, and the CUDA graphs (the scan engine's chunks, the guard's
skip under them, serving and the decode step) against the eager runs.

They carry the ``cuda`` marker and skip without a CUDA device. This file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed (the card's machine); there, skip the repo's conftest,
which imports JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core.scaling import scale_hyperparams
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import iterate_batches, make_ctr_dataset
from repro_torch.embed import store_for
from repro_torch.kernels.cowclip import (fused_cowclip_adam, reference,
                                         sparse_gather_catchup,
                                         sparse_gather_catchup_tables,
                                         sparse_update_scatter,
                                         sparse_update_scatter_tables,
                                         step_scalars)
from repro_torch.kernels.cowclip import ref as cc_ref
from repro_torch.kernels.cowclip.sparse import MAX_TABLES, launches_for
from repro_torch.kernels.embedding import (embedding_backward,
                                           embedding_backward_groups,
                                           field_layout, reference_groups,
                                           sort_plan)
from repro_torch.kernels.embedding import reference as embed_reference
from repro_torch.kernels.wkv6 import (chunked_wkv6_backward_reference,
                                      chunked_wkv6_reference,
                                      clipped_chunks,
                                      segmented_wkv6_reference, wkv6,
                                      wkv6_reference)
from repro_torch.kernels.wkv6.wkv6 import chunked_wkv6, segment_chunks
from repro_torch.models import ctr, lm, rwkv
from repro_torch.serve import ServingEngine
from repro_torch.serve.decode import GraphDecoder, greedy_generate
from repro_torch.train import engine as engine_lib
from repro_torch.train import train_ctr


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
    block = step_scalars(step, device="cuda")
    ref = reference(w, g, cnt, m, v, block)
    before = fused_cowclip_adam.launches
    out = fused_cowclip_adam(w, g, cnt, m, v, block)
    torch.cuda.synchronize()
    assert fused_cowclip_adam.launches == before + 1
    assert out[0] is w and out[1] is m and out[2] is v
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def _edge_counts(rows, which, seed):
    """Counts where every row is absent, every row touched, or half."""
    rng = np.random.default_rng(seed)
    if which == "absent":
        return np.zeros(rows, np.float32)
    if which == "touched":
        return rng.integers(1, 4, rows).astype(np.float32)
    return (rng.integers(1, 4, rows) * (rng.random(rows) < 0.5)).astype(
        np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [1, 2, 3, 10, 16, 17, 64])
@pytest.mark.parametrize("counts", ["absent", "touched", "half"])
@pytest.mark.parametrize("step", [1, 1000])
def test_torch_cowclip_cuda_kernel_edges(dim, counts, step):
    """The redesigned update's edges: D on both sides of the stream path's
    limit (16), a V that is no multiple of the rows a block covers (nor of
    4, so the last float4 is partial), all rows absent or all touched,
    and tables whose rows are not 16-byte aligned (the warp path);
    rtol 1e-5 / atol 1e-7 against the plain version."""
    _need_cuda()
    vocab = 5003
    for offset in (0, 1):      # 1: w and cnt start 4 bytes into a buffer
        w, g, _, m, v = _inputs(vocab, dim, seed=dim * 7 + step + offset)
        cnt = torch.from_numpy(_edge_counts(vocab, counts, dim + step)).cuda()
        if offset:
            w = torch.cat([w.new_zeros(1), w.flatten()])[1:].view(vocab, dim)
            cnt = torch.cat([cnt.new_zeros(1), cnt])[1:]
            assert w.data_ptr() % 16 and w.is_contiguous()
        block = step_scalars(step, device="cuda")
        ref = reference(w, g, cnt, m, v, block, lr=1e-3, l2=1e-4)
        out = fused_cowclip_adam(w, g, cnt, m, v, block, lr=1e-3, l2=1e-4)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_torch_cowclip_cuda_rejects_mixed_devices():
    _need_cuda()
    w, g, cnt, m, v = _inputs(8, 4, seed=0)
    with pytest.raises(ValueError):
        fused_cowclip_adam(w, g.cpu(), cnt, m, v,
                           step_scalars(1, device="cuda"))


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
    block = step_scalars(step, device="cuda")
    got = sparse_gather_catchup(c["w"], c["m"], c["v"], c["ls"], c["uids"],
                                c["counts"], block, **kw)
    want = cc_ref.sparse_gather_catchup_reference(
        c["w"], c["m"], c["v"], c["ls"], c["uids"], block, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a[real], b[real], rtol=1e-5, atol=1e-7)

    tables = [c[k].clone() for k in ("w", "m", "v", "ls")]
    out = sparse_update_scatter(*tables, c["uids"], c["counts"], got[0],
                                c["g"], got[1], got[2], block, **kw)
    want = cc_ref.sparse_update_scatter_reference(
        *(c[k] for k in ("w", "m", "v", "ls")), c["uids"], c["counts"],
        got[0], c["g"], got[1], got[2], block, **kw)
    torch.cuda.synchronize()
    assert all(a is b for a, b in zip(out, tables))
    for a, b in zip(out[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    assert torch.equal(out[3], want[3])
    assert (sparse_gather_catchup.launches, sparse_update_scatter.launches) \
        == (before[0] + 1, before[1] + 1)


# (rows, dim, cap, n_ids, off, vocab) of a mixed list of tables: pads, the
# CowClip-exempt D = 1, a capacity of 1, no real slot, a table full to its
# capacity with overflow, dim above a warp, rows that fill a warp's
# elements with one slot (300) or take several chunks (400), and a row
# shard whose pad uids land in its range
_GROUPED = ((50, 8, 12, 10, 0, None), (1000, 10, 512, 508, 0, None),
            (1000, 1, 512, 508, 0, None), (7, 8, 1, 1, 0, None),
            (30, 4, 6, 0, 0, None), (40, 8, 5, 200, 0, None),
            (400, 33, 64, 60, 0, None), (20, 300, 12, 10, 0, None),
            (16, 400, 6, 5, 0, None), (300, 10, 160, 156, 100, 380))


@pytest.mark.cuda
@pytest.mark.parametrize("n_tables", [len(_GROUPED), MAX_TABLES + 6],
                         ids=["mixed", "split"])
@pytest.mark.parametrize("step", [1, 1000])
def test_torch_sparse_cuda_grouped_match_plain(n_tables, step):
    """The grouped kernels over a mixed list (cycled to ``n_tables``; the
    split case takes two launches) against the plain versions table by
    table: catch-up rows on the real slots (pads finite), the tables after
    the update, ``last_step`` equal, and the depth equal to the plain
    formula and to the step's former per-table formula; rtol 1e-5 / atol
    1e-7."""
    _need_cuda()
    specs = [_GROUPED[i % len(_GROUPED)] for i in range(n_tables)]
    cases = [_sparse_case(rows, dim, cap, n_ids, step, seed=i + step,
                          off=off, vocab=vocab)
             for i, (rows, dim, cap, n_ids, off, vocab) in enumerate(specs)]
    offs = [spec[4] for spec in specs]
    kw = dict(lr=1e-3, l2=1e-4)
    lists = [[c[k] for c in cases] for k in ("w", "m", "v", "ls", "uids",
                                             "counts")]
    before = (sparse_gather_catchup_tables.launches,
              sparse_update_scatter_tables.launches)
    block = step_scalars(step, device="cuda")
    rows, depth = sparse_gather_catchup_tables(*lists, block,
                                               row_offsets=offs, **kw)
    tables = [[c[k].clone() for c in cases] for k in ("w", "m", "v", "ls")]
    sparse_update_scatter_tables(
        *tables, lists[4], lists[5], [r[0] for r in rows],
        [c["g"] for c in cases], [r[1] for r in rows], [r[2] for r in rows],
        block, row_offsets=offs, **kw)
    torch.cuda.synchronize()
    assert (sparse_gather_catchup_tables.launches,
            sparse_update_scatter_tables.launches) == tuple(
        b + launches_for(n_tables) for b in before)
    stacked = torch.stack([
        torch.max(torch.where(
            c["counts"] > 0,
            (step - 1) - c["ls"][torch.clamp(c["uids"].long() - off, 0,
                                             c["ls"].shape[0] - 1)], 0))
        for c, off in zip(cases, offs)]).max()
    assert depth.dtype == torch.int32 and depth.shape == ()
    assert int(depth) == int(stacked) == int(cc_ref.catchup_depth_reference(
        lists[3], lists[4], lists[5], block, row_offsets=offs))
    for i, (c, off) in enumerate(zip(cases, offs)):
        real = c["counts"] > 0
        want = cc_ref.sparse_gather_catchup_reference(
            c["w"], c["m"], c["v"], c["ls"], c["uids"], block, row_offset=off,
            **kw)
        for a, b in zip(rows[i], want):
            assert bool(torch.isfinite(a).all())
            torch.testing.assert_close(a[real], b[real], rtol=1e-5,
                                       atol=1e-7)
        want = cc_ref.sparse_update_scatter_reference(
            c["w"], c["m"], c["v"], c["ls"], c["uids"], c["counts"],
            rows[i][0], c["g"], rows[i][1], rows[i][2], block, row_offset=off,
            **kw)
        for a, b in zip((t[i] for t in tables[:3]), want[:3]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
        assert torch.equal(tables[3][i], want[3])


@pytest.mark.cuda
def test_torch_sparse_cuda_rejects_mixed_devices():
    _need_cuda()
    c = _sparse_case(64, 4, 8, 6, 3, seed=0)
    block = step_scalars(3, device="cuda")
    with pytest.raises(ValueError):
        sparse_gather_catchup(c["w"], c["m"], c["v"], c["ls"].cpu(),
                              c["uids"], c["counts"], block)
    rows = torch.zeros(8, 4, device="cuda")
    with pytest.raises(ValueError):
        sparse_update_scatter(c["w"], c["m"], c["v"], c["ls"], c["uids"],
                              c["counts"], rows, c["g"].cpu(), rows, rows,
                              block)
    with pytest.raises(ValueError):         # a step block on the host
        sparse_gather_catchup(c["w"], c["m"], c["v"], c["ls"], c["uids"],
                              c["counts"], step_scalars(3))


@pytest.mark.cuda
def test_torch_sparse_step_cuda_matches_cpu_and_repeats_bitwise():
    """Three sparse steps on the card against the CPU path, rtol 1e-5 /
    atol 1e-5; the same steps again on the card are bitwise equal (the row
    gradient is a sorted segment sum, no atomics); each sparse kernel
    launches once per step over all the tables (through the grouped
    wrappers, none through the single-table ones), the fused one never."""
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
        counters = (fused_cowclip_adam, sparse_gather_catchup,
                    sparse_update_scatter, sparse_gather_catchup_tables,
                    sparse_update_scatter_tables)
        before = [f.launches for f in counters]
        for b in iterate_batches(ds, 512, seed=0):
            params, state, _ = bundle.step(
                params, state,
                {k: torch.as_tensor(x, device=dev) for k, x in b.items()})
        params, state = bundle.flush(params, state)
        n = 0 if dev == "cpu" else 3
        assert [f.launches - b for f, b in zip(counters, before)] == [
            0, 0, 0, n, n]
        out[run] = [t.cpu() for t in tree_leaves(params)]
    for a, b, c in zip(out["cuda"], out["cpu"], out["cuda2"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        assert torch.equal(a, c)


def _wkv_inputs(bh, seq, n, seed, zero_frac=0.0):
    """The JAX kernel tests' distribution: r, k, v ~ N(0, 1), w =
    exp(-exp(wlog)) with wlog ~ N(-0.6, 1), u ~ N(0, 0.01); ``zero_frac``
    of the decays set to exactly 0."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((bh, seq, n)) for _ in range(3))
    w = np.exp(-np.exp(-0.6 + rng.standard_normal((bh, seq, n))))
    w = np.where(rng.random((bh, seq, n)) < zero_frac, 0.0, w)
    u = 0.1 * rng.standard_normal((bh, n))
    return [torch.from_numpy(a.astype(np.float32)).cuda()
            for a in (r, k, v, w, u)]


def _assert_wkv_bar(y, s, y_ref, s_ref):
    """The JAX kernel test's bar: max |dy| / max |y_ref| < 1e-4, and the
    state within rtol 1e-3 / atol 1e-4."""
    scale = y_ref.abs().max().item() + 1e-6
    assert (y - y_ref).abs().max().item() / scale < 1e-4
    torch.testing.assert_close(s, s_ref, rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,seq,n,chunk", [
    (2, 32, 16, 16), (4, 64, 32, 16), (1, 128, 64, 16), (8, 48, 8, 16),
    (2, 64, 16, 4), (2, 64, 16, 8), (4, 4096, 64, 16),
    (3, 48, 24, 16),             # a partial column tile (16 + 8)
])
def test_torch_wkv6_cuda_kernel_matches_plain(bh, seq, n, chunk):
    """The kernel against the chunked plain version (its function) and
    against the exact token recurrence, at the JAX sweep shapes and chunks
    and at N = 64, S = 4096; one launch per call. y equals the
    recurrence's only where no chunk's decay passes the factorisation's
    clip (``clipped_chunks`` 0); the final state always does."""
    _need_cuda()
    inp = _wkv_inputs(bh, seq, n, seed=bh * seq + n + chunk)
    before = wkv6.launches
    y, s = wkv6(*inp, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    _assert_wkv_bar(y, s, *chunked_wkv6_reference(*inp, chunk=chunk))
    y_ref, s_ref = wkv6_reference(*inp)
    torch.testing.assert_close(s, s_ref, rtol=1e-3, atol=1e-4)
    if clipped_chunks(inp[3], chunk=chunk) == 0:
        _assert_wkv_bar(y, s, y_ref, s_ref)


@pytest.mark.cuda
def test_torch_wkv6_cuda_kernel_zero_decays():
    """Exact zeros in w (subnormal 1e-38 floor, no flush to zero): y and
    state against the chunked plain version, the state against the exact
    recurrence (the factorisation's clip makes y inexact there, on both)."""
    _need_cuda()
    inp = _wkv_inputs(4, 64, 32, seed=11, zero_frac=0.05)
    y, s = wkv6(*inp)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    _assert_wkv_bar(y, s, *chunked_wkv6_reference(*inp))
    torch.testing.assert_close(s, wkv6_reference(*inp)[1], rtol=1e-3,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,seq,n,chunk,segment,zeros", [
    (3, 16, 64, 16, None, 0.0),     # one chunk
    (1, 16, 8, 16, None, 0.0),
    (1, 80, 16, 16, 2, 0.0),        # BH 1; 5 chunks, segments of 2 (ragged)
    (1, 112, 32, 8, 3, 0.0),        # 14 chunks, segments of 3
    (2, 64, 64, 4, 5, 0.0),         # 16 chunks, segments of 5
    (1, 4096, 64, 16, None, 0.0),   # BH 1: the card's own segment choice
    (2, 96, 16, 16, 1, 0.05),       # exact zeros in w, a chunk a segment
    (1, 256, 64, 16, 3, 0.05),
    (2, 40, 20, 8, 2, 0.0),         # N % 4 != 0: the scalar-load path
])
def test_torch_wkv6_cuda_segment_edges(bh, seq, n, chunk, segment, zeros):
    """The redesigned kernel's edges: a single chunk, segments that do not
    divide the chunks, BH = 1, N in {8, 16, 20, 32, 64}, chunks 4 / 8 / 16,
    exact zeros in w. Held at the wkv6 bar to the chunked plain version
    and to the segmented one with the same segment; finite everywhere."""
    _need_cuda()
    inp = _wkv_inputs(bh, seq, n, seed=seq + n + chunk, zero_frac=zeros)
    with torch.inference_mode():
        y, s = chunked_wkv6(*inp, chunk=chunk, segment=segment)
        torch.cuda.synchronize()
        seg = segment or segment_chunks(
            bh, seq // chunk,
            torch.cuda.get_device_properties(0).multi_processor_count)
        chunked = chunked_wkv6_reference(*inp, chunk=chunk)
        segmented = segmented_wkv6_reference(*inp, chunk=chunk, segment=seg)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    _assert_wkv_bar(y, s, *chunked)
    _assert_wkv_bar(y, s, *segmented)


def _wkv_grad_gaps(got, want, w):
    """Each of dr, dk, dv, d log w (= dw * w) and du: max abs difference
    over its largest magnitude in ``want``."""
    pairs = list(zip(got, want))
    pairs[3] = (got[3] * w, want[3] * w)
    gaps = []
    for g, a in pairs:
        scale = a.abs().max().item()
        err = (g - a).abs().max().item()
        gaps.append(err / scale if scale else err)
    return gaps


@pytest.mark.cuda
def test_torch_wkv6_cuda_rejects_bad_inputs():
    """A ragged S and mixed devices are refused. Inputs that require a
    gradient go through the kernel's forward (one launch, at the wkv6 bar
    against the plain chunked version) and the backward kernel (one
    launch): the gradients of r, k, v, u and log w (dw * w) within 1e-4 of
    their largest magnitude of autograd's through the plain chunked
    version on the card, for y's and the state's cotangents."""
    _need_cuda()
    inp = _wkv_inputs(1, 40, 8, seed=0)
    with pytest.raises(ValueError):
        wkv6(*inp, chunk=16)                       # ragged S
    inp = _wkv_inputs(1, 32, 8, seed=0)
    with pytest.raises(ValueError):
        wkv6(inp[0], inp[1].cpu(), *inp[2:])       # mixed devices
    inp = _wkv_inputs(4, 64, 32, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    gy = torch.randn(inp[0].shape, generator=gen, device="cuda")
    gs = torch.randn((4, 32, 32), generator=gen, device="cuda")
    grads, outs = {}, {}
    for name, fn in (("kernel", wkv6), ("plain", chunked_wkv6_reference)):
        ins = [t.clone().requires_grad_() for t in inp]
        before = (wkv6.launches, wkv6.backward_launches)
        y, s = fn(*ins, chunk=16)
        outs[name] = (y.detach(), s.detach())
        grads[name] = torch.autograd.grad((y * gy).sum() + (s * gs).sum(),
                                          ins)
        assert (wkv6.launches - before[0], wkv6.backward_launches
                - before[1]) == ((1, 1) if name == "kernel" else (0, 0))
    _assert_wkv_bar(*outs["kernel"], *outs["plain"])
    assert max(_wkv_grad_gaps(grads["kernel"], grads["plain"],
                              inp[3])) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("bh,seq,n", [(4, 64, 32), (1, 4000, 64),
                                      (512, 512, 64)])
def test_torch_wkv6_cuda_backward_matches_plain(bh, seq, n, monkeypatch):
    """``wkv6`` under autograd on the card (the forward kernel keeping its
    chunk states, then the backward kernel: one launch each, no CUDA
    tensor reaching the plain version) against the written-out plain
    backward from the plain chunk states and against autograd through the
    plain chunked version: dr, dk, dv, du and d log w (dw * w) each within
    1e-4 of its largest magnitude (the forward's bar), dw 0 exactly where
    the plain one is (w < 1e-38), finite; two runs bitwise equal. Some
    decays are 0 and a channel's chunks decay past the clip; y's and the
    state's cotangents together, and at the small shape each alone."""
    _need_cuda()
    from repro_torch.kernels.wkv6 import ops

    inp = _wkv_inputs(bh, seq, n, seed=bh + seq + n, zero_frac=0.01)
    inp[3][..., n - 1] = float(np.exp(-np.exp(3.0)))
    assert clipped_chunks(inp[3]) > 0
    gen = torch.Generator(device="cuda").manual_seed(seq)
    gy_all = torch.randn(inp[0].shape, generator=gen, device="cuda")
    gs_all = torch.randn((bh, n, n), generator=gen, device="cuda")
    plain_calls = [0]
    inner = ops.chunked_wkv6_reference

    def spy(*args, **kw):
        plain_calls[0] += args[0].is_cuda
        return inner(*args, **kw)

    for cot in ("both", "y", "state") if bh == 4 else ("both",):
        gy = gy_all if cot != "state" else torch.zeros_like(gy_all)
        gs = gs_all if cot != "y" else torch.zeros_like(gs_all)
        runs = []
        monkeypatch.setattr(ops, "chunked_wkv6_reference", spy)
        for _ in range(2):
            ins = [t.clone().requires_grad_() for t in inp]
            before = (wkv6.launches, wkv6.backward_launches)
            y, s = wkv6(*ins)
            loss = ((y * gy).sum() if cot != "state" else 0) \
                + ((s * gs).sum() if cot != "y" else 0)
            runs.append(torch.autograd.grad(loss, ins))
            torch.cuda.synchronize()
            assert (wkv6.launches - before[0],
                    wkv6.backward_launches - before[1]) == (1, 1)
        monkeypatch.setattr(ops, "chunked_wkv6_reference", inner)
        assert plain_calls[0] == 0
        got = runs[0]
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        kept = chunked_wkv6_reference(*inp, chunk_states=True)[2]
        written = chunked_wkv6_backward_reference(*inp, kept, gy, gs)
        ins = [t.clone().requires_grad_() for t in inp]
        y, s = chunked_wkv6_reference(*ins)
        auto = torch.autograd.grad((y * gy).sum() + (s * gs).sum(), ins)
        for want in (written, auto):
            assert max(_wkv_grad_gaps(got, want, inp[3])) <= 1e-4
        dead = inp[3] < 1e-38
        assert bool((got[3][dead] == 0).all())
        assert bool((auto[3][dead] == 0).all())
        assert all(bool(torch.isfinite(g).all()) for g in got)
        del runs, got, written, auto, kept, ins, y, s


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [23, 4000])
def test_torch_rwkv_mixer_cuda_ragged_lengths(seq):
    """A length that is no multiple of the chunk goes through the kernel,
    padded to a whole chunk: one launch for the layer. y and the final
    state handed to decode match the CPU path (the plain chunked version,
    padded the same way) and the exact token scan on the card, at the wkv6
    bar (max |dy| / max |y| < 1e-4; state rtol 1e-3 / atol 1e-4)."""
    _need_cuda()
    d_model, n_heads = 256, 4
    params = rwkv.init_rwkv6(torch.Generator().manual_seed(seq), d_model,
                             n_heads, device="cpu")
    on_card = tree_map(lambda t: t.cuda(), params)
    x = torch.from_numpy((0.5 * np.random.default_rng(seq).standard_normal(
        (2, seq, d_model))).astype(np.float32))
    with torch.inference_mode():
        before = wkv6.launches
        y, s = rwkv.rwkv6_train(on_card, x.cuda(), n_heads=n_heads,
                                backend="chunked", return_state=True)
        torch.cuda.synchronize()
        assert wkv6.launches == before + 1
        y_scan, s_scan = rwkv.rwkv6_train(on_card, x.cuda(), n_heads=n_heads,
                                          backend="scan", return_state=True)
        y_cpu, s_cpu = rwkv.rwkv6_train(params, x, n_heads=n_heads,
                                        backend="chunked", return_state=True)
    _assert_wkv_bar(y.cpu(), s.cpu(), y_cpu, s_cpu)
    _assert_wkv_bar(y, s, y_scan, s_scan)


@pytest.mark.cuda
def test_torch_rwkv_lm_cuda_matches_cpu():
    """The reduced rwkv6-7b (f32) on the card against the CPU path, from
    the same params: chunked forward logits (one kernel launch per layer),
    the cached prefill and 4 decode steps fed the same tokens; max abs
    1e-4, the LM bar of the CPU tests against JAX."""
    _need_cuda()
    cfg = dataclasses.replace(reduce_config(get_config("rwkv6-7b")),
                              wkv_backend="chunked")
    params = lm.init(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)))
    feed = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 2)))
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        before = wkv6.launches
        with torch.inference_mode():
            logits, _ = lm.forward(p, cfg, tokens.to(dev))
            launched = wkv6.launches - before
            last, cache, cur = lm.prefill_with_cache(p, cfg, tokens.to(dev),
                                                     68)
            steps = [last]
            for i in range(4):
                step, cache = lm.decode_step(p, cfg, feed[i].to(dev), cache,
                                             cur + i)
                steps.append(step)
        assert launched == (cfg.n_layers if dev == "cuda" else 0)
        out[dev] = [t.cpu() for t in [logits] + steps]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert (a - b).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-7b", "gemma3-12b", "zamba2-2.7b",
                                  "granite-moe-3b-a800m", "musicgen-large"])
def test_torch_lm_train_step_cuda_matches_cpu(arch):
    """``chip_smoke.lm_step_agree`` (phase 47's check, one copy): 3 steps
    of ``make_lm_train_step`` at the reduced f32 size on the card (rwkv6
    through the wkv6 kernel) against the CPU along the card's trajectory:
    the loss within 1e-4, every gradient leaf within 1e-4 of its own
    largest value (rwkv6 its own bar, ``LM_GRAD_BAR_RWKV6``), each step's
    launches (the fused CowClip kernel once, the embedding backward once,
    wkv6 once a rwkv6 layer), every param within 1e-4 of the CPU's update
    of the card's gradients."""
    _need_cuda()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import lm_step_agree

    lm_step_agree(arch)


# ---------------------------------------------------------------------------
# the Mamba-2 scan: forward and backward kernels
# ---------------------------------------------------------------------------


def _ssd_inputs(b, s, h, p, n, seed, dt_shift=-2.0):
    """f32 inputs of the scan on the card from numpy, and the cotangents
    of y and of the final state."""
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    dt = np.log1p(np.exp(arr(b, s, h) + dt_shift)).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    ins = (arr(b, s, h, p), arr(b, s, n), arr(b, s, n), dt, a_log, arr(h))
    return ([torch.from_numpy(t).cuda() for t in ins],
            torch.from_numpy(arr(b, s, h, p)).cuda(),
            torch.from_numpy(arr(b, h, p, n)).cuda())


def _rel(got, want):
    return (got - want).abs().max().item() / max(want.abs().max().item(),
                                                 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,dt_shift", [
    (1, 1, 3, 16, 64, -2.0), (2, 70, 5, 20, 16, -2.0),
    (1, 333, 4, 64, 64, -2.0), (3, 48, 2, 8, 1, -2.0),
    (1, 40, 3, 64, 64, 14.0), (2, 33, 2, 80, 32, -2.0),
    (2, 512, 80, 64, 64, -2.0)])
def test_torch_ssd_cuda_kernels_match_plain(b, s, h, p, n, dt_shift):
    """The forward kernel (through ``ssd_scan``, one launch) against the
    plain token loop and against the chunk form on the card: y, the final
    state and the kept chunk states within 1e-5 of their largest value;
    the backward kernels from the kernel's kept states against the
    written-out plain backward and the chunk form's plain backward on the
    card, every gradient within 1e-4 of its largest value, and two runs
    bitwise equal. Shapes cover one token, P no multiple of 16 and P over
    the 64 rows a block holds (two groups of rows), N < 64 down to 1, a
    ragged last chunk, decays that underflow to 0 (dt_shift 14) and
    zamba2-2.7b's training call (2 x 512 tokens, 80 heads)."""
    _need_cuda()
    from repro_torch.kernels.ssd import (ssd_scan,
                                         ssd_scan_backward_chunked_reference,
                                         ssd_scan_backward_reference,
                                         ssd_scan_chunked_reference,
                                         ssd_scan_reference)

    ins, gy, gs = _ssd_inputs(b, s, h, p, n, seed=s + n, dt_shift=dt_shift)
    before = ssd_scan.launches
    y, s_fin = ssd_scan(*ins)
    assert ssd_scan.launches == before + 1
    _, _, kept = torch.ops.repro_torch.ssd_scan_fwd(*ins, True)
    want = ssd_scan_reference(*ins, chunk_states=True)
    chunked = ssd_scan_chunked_reference(*ins)
    for got, w, c in zip((y, s_fin, kept), want, chunked):
        assert _rel(got, w) <= 1e-5
        assert _rel(got, c) <= 1e-5
    grads = torch.ops.repro_torch.ssd_scan_bwd(*ins, kept, gy, gs)
    again = torch.ops.repro_torch.ssd_scan_bwd(*ins, kept, gy, gs)
    plain = ssd_scan_backward_reference(*ins, want[2], gy, gs)
    chunk_form = ssd_scan_backward_chunked_reference(*ins, want[2], gy, gs)
    for g, a, w, c in zip(grads, again, plain, chunk_form):
        assert torch.equal(g, a)
        assert _rel(g, w) <= 1e-4
        assert _rel(g, c) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,segment", [
    (2, 70, 5, 20, 16, 1), (2, 70, 5, 20, 16, 2), (1, 333, 4, 64, 64, 5),
    (3, 48, 2, 8, 1, 1), (1, 1000, 80, 64, 64, 7), (1, 4096, 80, 64, 64, 64)])
def test_torch_ssd_cuda_segments_match_plain(b, s, h, p, n, segment):
    """The forward with each (b, h)'s chunks cut into segments of
    ``segment`` (a pass from a zero state, the carry, the scan from each
    segment's incoming state; ragged last segments too) against the plain
    token loop: y, the final state and the kept chunk states within 1e-5
    of their largest value, and the same bits as a second run."""
    _need_cuda()
    from repro_torch.kernels.ssd import ssd as launcher
    from repro_torch.kernels.ssd import ssd_scan_reference

    ins, _, _ = _ssd_inputs(b, s, h, p, n, seed=s + segment)
    want = ssd_scan_reference(*ins, chunk_states=True)
    got = launcher.forward(*ins, True, segment=segment)
    again = launcher.forward(*ins, True, segment=segment)
    for a, c, w in zip(got, again, want):
        assert torch.equal(a, c)
        assert _rel(a, w) <= 1e-5


@pytest.mark.cuda
def test_torch_ssd_cuda_autograd_matches_plain_autograd():
    """``ssd_scan`` under autograd on the card (the forward kernel keeping
    its chunk states, then the backward kernels: one launch each) against
    autograd of the plain loop on the card, for y's and the state's
    cotangents and for y's alone; mixed devices and a CUDA tensor that is
    not f32 are refused."""
    _need_cuda()
    from repro_torch.kernels.ssd import ssd_scan, ssd_scan_reference

    ins, gy, gs = _ssd_inputs(2, 50, 3, 32, 64, seed=5)
    for cot in ("both", "y"):
        grads = {}
        for name, fn in (("kernel", ssd_scan), ("plain", ssd_scan_reference)):
            leaves = [t.clone().requires_grad_() for t in ins]
            before = (ssd_scan.launches, ssd_scan.backward_launches)
            y, s = fn(*leaves)
            loss = (y * gy).sum() + ((s * gs).sum() if cot == "both" else 0)
            grads[name] = torch.autograd.grad(loss, leaves,
                                              allow_unused=True)
            want = (1, 1) if name == "kernel" else (0, 0)
            assert (ssd_scan.launches - before[0],
                    ssd_scan.backward_launches - before[1]) == want
        for g, w in zip(grads["kernel"], grads["plain"]):
            w = torch.zeros_like(g) if w is None else w
            assert _rel(g, w) <= 1e-4
    with pytest.raises(ValueError):
        ssd_scan(ins[0], ins[1].cpu(), *ins[2:])
    with pytest.raises(TypeError):
        ssd_scan(ins[0].half(), *ins[1:])


# ---------------------------------------------------------------------------
# CUDA graphs: the scan engine, the guard, serving, decode
# ---------------------------------------------------------------------------


def _small_ctr(placement):
    cfg = ctr.CTRConfig(name="deepfm", vocab_sizes=(2000, 700, 120, 30, 5),
                        n_dense=4, emb_dim=8, mlp_dims=(32, 32, 32),
                        emb_sigma=1e-2, placement=placement)
    hp = scale_hyperparams("cowclip", base_lr=1e-3, base_l2=1e-3,
                           base_batch=256, batch_size=512, base_dense_lr=2e-3)
    ds = make_ctr_dataset(11 * 512 + 100, cfg.vocab_sizes, n_dense=4, seed=1)
    return cfg, hp, ds


def _flat(tree):
    from repro_torch.core.tree import flatten_with_paths

    return {k: v.cpu() for k, v in flatten_with_paths(tree).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["fused", "sparse", "substrate"])
def test_torch_scan_engine_cuda_graph_equals_eager(placement):
    """train_ctr on the card over 2 epochs of 10 batches, scan_steps 4 (a
    tail chunk of 2) and a max_steps cut at 13: the graph replays' params,
    state and losses equal the eager steps' bit for bit; 3 graphs (k = 4,
    2 and the cut's 3)."""
    _need_cuda()
    cfg, hp, ds = _small_ctr(placement)
    tr, te = ds.split(0.95)
    params0 = ctr.init(cfg, seed=2, device="cpu")
    res, runners = {}, []
    real = engine_lib.make_chunk_runner

    def spy(step):
        runners.append(real(step))
        return runners[-1]

    engine_lib.make_chunk_runner = spy
    try:
        for eng in ("eager", "scan"):
            bundle = store_for(cfg).make_bundle(cfg, hp, warmup_steps=3)
            params = tree_map(lambda t: t.clone().cuda(), params0)
            res[eng] = train_ctr(
                cfg, None, tr, te, batch_size=512, epochs=2, seed=0,
                step_bundle=bundle, max_steps=13, engine=eng, scan_steps=4,
                init_state=(params, bundle.init(params)))
    finally:
        engine_lib.make_chunk_runner = real
    a, b = res["eager"], res["scan"]
    assert a.steps == b.steps == 13 and a.losses == b.losses
    for x, y in ((a.params, b.params), (a.opt_state, b.opt_state)):
        fx, fy = _flat(x), _flat(y)
        for k in fx:
            assert torch.equal(fx[k], fy[k]), k
    assert runners[0].n_captures == 3
    assert a.final_eval["auc"] == b.final_eval["auc"]


@pytest.mark.cuda
@pytest.mark.parametrize("placement",
                         ["fused", "sparse", "substrate", "hotcold"])
def test_torch_scan_engine_cuda_guard_skips_inside_a_graph(placement):
    """A chunk of 4 with a NaN dense feature in its second batch, replayed
    from a graph under nonfinite_guard: the same params and state as the
    guarded eager steps, bit for bit, skipped_steps summing to 1, and the
    poisoned step alone changes nothing (its tables, moments, last_step
    and step bitwise as before)."""
    _need_cuda()
    from repro_torch.data.prefetch import chunk_epoch

    cfg, hp, ds = _small_ctr(placement)
    bundle = store_for(cfg).make_bundle(cfg, hp, warmup_steps=3,
                                        nonfinite_guard=True)
    chunk = next(chunk_epoch(ds, 512, 4, seed=3))
    chunk["dense"][1, 0, 0] = np.nan
    chunk = {k: torch.from_numpy(v).cuda() for k, v in chunk.items()}
    params0 = ctr.init(cfg, seed=3, device="cuda")

    p = tree_map(torch.clone, params0)
    s = bundle.init(p)
    p, s, _ = bundle.step(p, s, {k: v[0] for k, v in chunk.items()})
    before = {k: v.clone() for k, v in _flat({"p": p, "s": s}).items()}
    p, s, aux = bundle.step(p, s, {k: v[1] for k, v in chunk.items()})
    assert int(aux["skipped_steps"]) == 1
    after = _flat({"p": p, "s": s})
    for k in before:
        assert torch.equal(before[k], after[k]), k
    for i in (2, 3):
        p, s, _ = bundle.step(p, s, {k: v[i] for k, v in chunk.items()})
    eager = _flat({"p": p, "s": s})

    p = tree_map(torch.clone, params0)
    s = bundle.init(p)
    runner = engine_lib.make_chunk_runner(engine_lib.resolve_scan_step(bundle))
    p, s, aux = runner(p, s, chunk)
    counters = ([s["step"]] if isinstance(s, dict) else
                [v for k, v in _flat(s).items() if k.endswith("count")])
    assert int(aux["skipped_steps"].sum()) == 1
    assert counters and all(int(c) == 3 for c in counters)
    graph = _flat({"p": p, "s": s})
    for k in eager:
        assert torch.equal(eager[k], graph[k]), k


@pytest.mark.cuda
def test_torch_scan_engine_capture_with_a_host_read_raises():
    """A step that reads its loss on the host cannot be captured: the
    runner raises (no eager fallback), and the training state is as it
    was."""
    _need_cuda()
    from repro_torch.data.prefetch import chunk_epoch

    cfg, hp, ds = _small_ctr("fused")
    bundle = store_for(cfg).make_bundle(cfg, hp)

    def reading_step(params, state, batch):
        out = bundle.step(params, state, batch)
        float(out[2]["loss"])
        return out

    params = ctr.init(cfg, seed=4, device="cuda")
    state = bundle.init(params)
    before = {k: v.clone() for k, v in _flat(
        {"p": params, "s": state}).items()}
    chunk = {k: torch.from_numpy(v).cuda()
             for k, v in next(chunk_epoch(ds, 512, 2, seed=0)).items()}
    with pytest.raises(RuntimeError):
        engine_lib.make_chunk_runner(reading_step)(params, state, chunk)
    torch.cuda.synchronize()
    after = _flat({"p": params, "s": state})
    for k in before:
        assert torch.equal(before[k], after[k]), k


@pytest.mark.cuda
def test_torch_cuda_bias_corrections_equal_host_rounding():
    """``core.optim.bias_corrections`` of counters on the card (as a train
    step fills its block; CUDA's own powf would round b^t an ulp off the
    host's for some t) equals the host's ``bias_corrections(t)`` bit for
    bit, t = 1 .. 20000, and a block filled from a counter on the card
    carries those bits."""
    _need_cuda()
    from repro_torch.core import optim
    from repro_torch.kernels.cowclip.cowclip import bias_corrections

    def bits(x):
        return int(np.float32(x).view(np.int32))

    steps = torch.arange(1, 20001, dtype=torch.int32, device="cuda")
    for b1, b2 in ((0.9, 0.999), (0.8, 0.99)):
        got = [c.view(torch.int32).cpu().tolist()
               for c in optim.bias_corrections(steps, b1, b2)]
        for t in range(1, 20001):
            want = bias_corrections(t, b1, b2)
            assert [got[0][t - 1], got[1][t - 1]] == [
                bits(w) for w in want], (b1, b2, t)
    for t in (1, 2, 17, 1000, 19999):
        words = step_scalars(torch.tensor(t, dtype=torch.int32,
                                          device="cuda")).words
        want = bias_corrections(t, 0.9, 0.999)
        assert words.tolist() == [t, bits(want[0]), bits(want[1]), 1]


@pytest.mark.cuda
@pytest.mark.parametrize("flag", [False, True])
def test_torch_cowclip_cuda_kernels_read_the_guard_flag(flag):
    """A guarded step block with flag 0: the fused and the sparse update
    kernels write nothing; flag 1: the unguarded kernels' result bit for
    bit (and the plain versions' at rtol 1e-5 / atol 1e-7)."""
    _need_cuda()
    t = torch.tensor(7, dtype=torch.int32, device="cuda")
    guarded = step_scalars(t, ok=torch.tensor(flag, device="cuda"))
    plain_block = step_scalars(t)
    w, g, cnt, m, v = _inputs(1000, 10, seed=5)
    runs = []
    for block in (guarded, plain_block):
        tables = [x.clone() for x in (w, m, v)]
        fused_cowclip_adam(tables[0], g, cnt, tables[1], tables[2], block)
        runs.append(tables)
    want = reference(w, g, cnt, m, v, guarded)
    torch.cuda.synchronize()
    for a, b, old, r in zip(runs[0], runs[1], (w, m, v), want):
        assert torch.equal(a, b if flag else old)
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-7)

    c = _sparse_case(1000, 10, 256, 400, 7, seed=6)
    rows, _ = sparse_gather_catchup_tables(
        [c["w"]], [c["m"]], [c["v"]], [c["ls"]], [c["uids"]], [c["counts"]],
        guarded)
    outs = []
    for block in (guarded, plain_block):
        tables = [c[k].clone() for k in ("w", "m", "v", "ls")]
        sparse_update_scatter_tables(
            *[[x] for x in tables], [c["uids"]], [c["counts"]],
            [rows[0][0]], [c["g"]], [rows[0][1]], [rows[0][2]], block)
        outs.append(tables)
    torch.cuda.synchronize()
    for a, b, old in zip(outs[0], outs[1], (c["w"], c["m"], c["v"],
                                             c["ls"])):
        assert torch.equal(a, b if flag else old)


@pytest.mark.cuda
def test_torch_serving_engine_cuda_one_capture():
    """The serving engine on the card: scores of 1 to 300 rows equal the
    eager forward within 1e-5 through one captured graph."""
    _need_cuda()
    cfg, _, _ = _small_ctr("fused")
    params = ctr.init(cfg, seed=5, device="cuda")
    rng = np.random.default_rng(0)
    ids = np.stack([rng.integers(0, v, 300) for v in cfg.vocab_sizes],
                   1).astype(np.int32)
    dense = rng.normal(size=(300, 4)).astype(np.float32)
    with torch.inference_mode():
        ref = ctr.apply(params, cfg, torch.from_numpy(ids).cuda(),
                        torch.from_numpy(dense).cuda()).cpu().numpy()
    eng = ServingEngine(cfg, params, batch_size=64)
    for n in (1, 3, 64, 65, 300):
        np.testing.assert_allclose(eng.score(ids[:n], dense[:n]), ref[:n],
                                   atol=1e-5)
    assert eng.n_traces == 1


@pytest.mark.cuda
def test_torch_decode_graph_cuda_equals_eager():
    """Greedy decoding of the reduced rwkv6-7b on the card: the replayed
    decode graph gives the eager steps' tokens, and logits within 1e-4;
    one capture per batch size."""
    _need_cuda()
    cfg = dataclasses.replace(reduce_config(get_config("rwkv6-7b")),
                              wkv_backend="chunked")
    params = lm.init(cfg, seed=0, device="cuda")
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, 32))).cuda()
    eager = greedy_generate(params, cfg, prompt, 12, graph=False)
    decoder = GraphDecoder(params, cfg)
    for _ in range(2):
        got = greedy_generate(params, cfg, prompt, 12, decoder=decoder)
        assert torch.equal(got.tokens, eager.tokens)
        assert (got.logits - eager.logits).abs().max().item() <= 1e-4
    assert list(decoder.graphs) == [(3, None)]


@pytest.mark.cuda
def test_torch_attn_decode_graph_cuda_equals_eager():
    """Greedy decoding of the reduced gemma3-12b (window 8: a ring and a
    linear KV cache) on the card, 12 tokens after a 6-token prompt, so the
    ring wraps inside the replays: the graph, its cursor on the card, gives
    the eager steps' tokens, and logits within 1e-4; one capture per
    (batch, max_len); the CPU's steps fed the same tokens end within 1e-4
    of the eager run's logits."""
    _need_cuda()
    cfg = reduce_config(get_config("gemma3-12b"))
    params = lm.init(cfg, seed=0, device="cuda")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (3, 6))).cuda()
    eager = greedy_generate(params, cfg, prompt, 12, graph=False)
    decoder = GraphDecoder(params, cfg)
    for _ in range(2):
        got = greedy_generate(params, cfg, prompt, 12, decoder=decoder)
        assert torch.equal(got.tokens, eager.tokens)
        assert (got.logits - eager.logits).abs().max().item() <= 1e-4
    assert list(decoder.graphs) == [(3, 18)]
    graph = decoder.graphs[3, 18]
    assert int(graph.cursor) == 18 and graph.position == 18
    with pytest.raises(ValueError, match="max_len"):
        graph.step()
    cpu = tree_map(lambda t: t.cpu(), params)
    with torch.inference_mode():
        _, cache, cur = lm.prefill_with_cache(cpu, cfg, prompt.cpu(), 18)
        for i in range(12):
            logits, cache = lm.decode_step(cpu, cfg, eager.tokens[:, i].cpu(),
                                           cache, cur + i)
    assert (logits - eager.logits.cpu()).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "granite-moe-3b-a800m"])
def test_torch_hybrid_moe_decode_graph_cuda_equals_eager(arch):
    """Greedy decoding of reduced zamba2 (Mamba-2 states and the shared
    block's rings of 8, which wrap inside the replays) and granite-moe (a
    linear KV cache and the MoE's router, sorts and gathers on the card)
    from one graph: the eager steps' tokens, logits within 1e-4; one
    capture per (batch, max_len); no step past max_len; the CPU's steps
    fed the same tokens end within 1e-4 of the eager logits."""
    _need_cuda()
    cfg = reduce_config(get_config(arch))
    params = lm.init(cfg, seed=0, device="cuda")
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 6))).cuda()
    eager = greedy_generate(params, cfg, prompt, 12, graph=False)
    decoder = GraphDecoder(params, cfg)
    for _ in range(2):
        got = greedy_generate(params, cfg, prompt, 12, decoder=decoder)
        assert torch.equal(got.tokens, eager.tokens)
        assert (got.logits - eager.logits).abs().max().item() <= 1e-4
    assert list(decoder.graphs) == [(3, 18)]
    graph = decoder.graphs[3, 18]
    assert int(graph.cursor) == 18 and graph.position == 18
    with pytest.raises(ValueError, match="max_len"):
        graph.step()
    cpu = tree_map(lambda t: t.cpu(), params)
    with torch.inference_mode():
        _, cache, cur = lm.prefill_with_cache(cpu, cfg, prompt.cpu(), 18)
        for i in range(12):
            logits, cache = lm.decode_step(cpu, cfg, eager.tokens[:, i].cpu(),
                                           cache, cur + i)
    assert (logits - eager.logits.cpu()).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_torch_fused_grads_cuda_deterministic_mode():
    """One fused step's gradients at batch 4096, twice from the same
    params and batch: bitwise equal under torch.use_deterministic_algorithms
    (the mode in which chip_smoke.py holds the scan engine to the eager
    one at full width). Under the default algorithms PyTorch's CUDA
    embedding backward is not deterministic past 3072 indices on fields
    whose ids repeat heavily (ROADMAP queue 3)."""
    _need_cuda()
    from repro_torch.core.tree import flatten_with_paths
    from repro_torch.train.loop import _loss_and_grads

    cfg = ctr.CTRConfig(name="deepfm", vocab_sizes=(20000, 300, 40),
                        n_dense=4, emb_dim=10, mlp_dims=(64, 64),
                        emb_sigma=1e-2)
    ds = make_ctr_dataset(4096, cfg.vocab_sizes, n_dense=4, zipf_a=1.1,
                          seed=2)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(iterate_batches(ds, 4096, seed=0)).items()}
    params = ctr.init(cfg, seed=1, device="cuda")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        grads = [flatten_with_paths(_loss_and_grads(params, cfg, batch)[1])
                 for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


@pytest.mark.cuda
def test_torch_prefetch_cuda_stages_items_in_order():
    """The CUDA prefetch: items of several lengths, each pinned on the
    consumer's side and copied on a side stream, reach the card in order,
    equal to their host arrays; closing early stops the worker."""
    _need_cuda()
    from repro_torch.data.prefetch import prefetch

    rng = np.random.default_rng(0)
    items = [{"a": rng.standard_normal((n, 3)).astype(np.float32),
              "b": rng.integers(0, 9, (n,)).astype(np.int32)}
             for n in (8, 8, 8, 5, 8, 12, 8, 8, 8, 8, 3)]
    got = list(prefetch(iter(items), device="cuda"))
    torch.cuda.synchronize()
    assert len(got) == len(items)
    for g, want in zip(got, items):
        for k, v in want.items():
            assert g[k].device.type == "cuda"
            np.testing.assert_array_equal(g[k].cpu().numpy(), v)
    it = prefetch(iter(items), device="cuda")
    first = next(it)
    it.close()
    np.testing.assert_array_equal(first["a"].cpu().numpy(), items[0]["a"])


def _embed_case(n, vocab, dim, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "zipf":
        ids = np.minimum(rng.zipf(1.1, n) - 1, vocab - 1)
    else:
        ids = rng.integers(0, vocab, n)
    if kind == "drops":
        ids[::5] = vocab + rng.integers(0, 3, ids[::5].shape)
    cot = (0.1 * rng.standard_normal((n, dim))).astype(np.float32)
    return (torch.from_numpy(ids.astype(np.int32)).cuda(),
            torch.from_numpy(cot).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [1, 10, 16, 17, 64])
@pytest.mark.parametrize("n,vocab,kind", [
    (1, 5, "uniform"), (33, 5, "uniform"), (5000, 40, "zipf"),
    (70000, 3000, "zipf"), (20000, 100, "drops"), (4096, 1000000, "uniform")])
def test_torch_embedding_backward_cuda_matches_plain(dim, n, vocab, kind):
    """The kernel against its plain version (the same order of additions):
    bitwise equal; one kernel run a call; ids past the table pass
    nothing."""
    _need_cuda()
    ids, cot = _embed_case(n, vocab, dim, seed=n + dim, kind=kind)
    want = embed_reference(ids, cot, vocab)
    before = embedding_backward_groups.launches
    got = embedding_backward(ids, cot, vocab)
    torch.cuda.synchronize()
    assert embedding_backward_groups.launches == before + 1
    assert got.shape == (vocab, dim) and got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_torch_embedding_backward_cuda_repeats_bitwise():
    """A 131,072-row field of 3 Zipf ids (two segments of tens of
    thousands of rows) at D = 10, twice: bitwise equal, and equal to the
    plain version; where PyTorch's own backward differed run to run."""
    _need_cuda()
    rng = np.random.default_rng(0)
    ids = np.minimum(rng.zipf(1.5, 131072) - 1, 2).astype(np.int32)
    cot = (1e-3 * rng.standard_normal((131072, 10))).astype(np.float32)
    ids_t, cot_t = torch.from_numpy(ids).cuda(), torch.from_numpy(cot).cuda()
    first = embedding_backward(ids_t, cot_t, 3)
    second = embedding_backward(ids_t, cot_t, 3)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    torch.testing.assert_close(first, embed_reference(ids_t, cot_t, 3),
                               rtol=1e-5, atol=1e-7)
    assert np.bincount(ids, minlength=3).min() > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(10, 1), (10, 1, 16), (3, 64, 1, 17)])
def test_torch_embedding_backward_cuda_groups_match_plain(dims):
    """One call over groups read at the same keys (the fm and LR lookups'
    D = 10 and 1; 3 and 4 groups, a D past 32 among them) on 8 Zipf
    fields of 20,000 rows (runs across chunks, dropped ids): each group
    equals the plain version on the same plan and the kernel's single
    call for that group, bitwise; twice, bitwise."""
    _need_cuda()
    rng = np.random.default_rng(sum(dims))
    vocabs = (3, 40, 1000, 7, 100000, 2, 500, 30000)
    ids = np.stack([np.minimum(rng.zipf(1.2, 20000) - 1, v - 1)
                    for v in vocabs], axis=1).astype(np.int32)
    ids[::11, 3] = 7                                 # past its table
    layout = field_layout(vocabs, torch.device("cuda"))
    keys = layout.keys(torch.from_numpy(ids).cuda())
    cots = [torch.from_numpy((0.1 * rng.standard_normal(
        (keys.numel(), d))).astype(np.float32)).cuda() for d in dims]
    plan = sort_plan(keys)
    got = embedding_backward_groups(plan, cots, layout.rows)
    again = embedding_backward_groups(plan, cots, layout.rows)
    want = reference_groups(plan, cots, layout.rows)
    torch.cuda.synchronize()
    for g, a, w, cot in zip(got, again, want, cots):
        assert torch.equal(g, w) and torch.equal(g, a)
        assert torch.equal(g, embedding_backward(keys, cot, layout.rows))


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [0, 64])
def test_torch_embedding_backward_cuda_slot_plan(cap):
    """The sparse step's backward through ``lookup_rows`` (fm D = 10 and
    LR D = 1 slot rows, no sort: the dedups' plan), with and without
    overflow: the kernel equals the plain version on the same plan,
    bitwise, and the card equals the CPU."""
    _need_cuda()
    from repro_torch.models import embedding as emb

    rng = np.random.default_rng(cap)
    vocabs = (3, 40, 1000, 100000)
    ids = np.stack([np.minimum(rng.zipf(1.2, 8192) - 1, v - 1)
                    for v in vocabs], axis=1).astype(np.int32)
    caps = [u.capacity for u in emb.batch_unique(
        torch.from_numpy(ids), vocabs, cap).values()]
    rows_np = [[(0.1 * rng.standard_normal((c, d))).astype(np.float32)
                for c in caps] for d in (10, 1)]
    cots_np = [(0.1 * rng.standard_normal((8192, len(vocabs), d))).astype(
        np.float32) for d in (10, 1)]
    out = {}
    for dev in ("cpu", "cuda"):
        uniq = emb.batch_unique(torch.from_numpy(ids).to(dev), vocabs, cap)
        rows = [{f"field_{i}": torch.from_numpy(r).to(dev).requires_grad_()
                 for i, r in enumerate(g)} for g in rows_np]
        before = sort_plan.sorts
        outs = emb.lookup_rows(rows, uniq)
        out[dev] = torch.autograd.grad(
            outs, [t for g in rows for t in g.values()],
            [torch.from_numpy(c).to(dev) for c in cots_np])
        assert sort_plan.sorts == before
    assert (cap == 0) != any(u.inv.max() >= c for u, c in zip(
        uniq.values(), caps))                      # overflow iff capped
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_torch_fused_grads_cuda_deterministic_by_default():
    """One fused step's gradients at batch 4096, twice from the same params
    and batch, under PyTorch's default algorithms: bitwise equal (the
    port's embedding backward; ROADMAP queue 3, closed)."""
    _need_cuda()
    from repro_torch.core.tree import flatten_with_paths
    from repro_torch.train.loop import _loss_and_grads

    cfg = ctr.CTRConfig(name="deepfm", vocab_sizes=(20000, 300, 40, 3),
                        n_dense=4, emb_dim=10, mlp_dims=(64, 64),
                        emb_sigma=1e-2)
    ds = make_ctr_dataset(4096, cfg.vocab_sizes, n_dense=4, zipf_a=1.1,
                          seed=2)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(iterate_batches(ds, 4096, seed=0)).items()}
    params = ctr.init(cfg, seed=1, device="cuda")
    assert not torch.are_deterministic_algorithms_enabled()
    before = (embedding_backward_groups.launches, sort_plan.sorts)
    grads = [flatten_with_paths(_loss_and_grads(params, cfg, batch)[1])
             for _ in range(2)]
    # fm and lin in one call and one sort, twice
    assert (embedding_backward_groups.launches, sort_plan.sorts) == (
        before[0] + 2, before[1] + 2)
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("clip", ["adaptive_column", "global",
                                  "adaptive_field", "none"])
def test_torch_substrate_step_cuda_matches_cpu(clip):
    """Three substrate steps on the card against the CPU path (which the
    CPU tests hold to the JAX package), rtol 1e-5 / atol 1e-5; the
    embedding backward runs once a step (fm and lin in one call) on the
    card."""
    _need_cuda()
    from repro_torch.core import build_train_step

    cfg, hp, ds = _small_ctr("substrate")
    params0 = ctr.init(cfg, seed=1, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        bundle = build_train_step(cfg, hp, clip_kind=clip, clip_t=0.5,
                                  warmup_steps=2)
        params = tree_map(lambda t: t.clone().to(dev), params0)
        state = bundle.init(params)
        before = embedding_backward_groups.launches
        for b in list(iterate_batches(ds, 512, seed=0))[:3]:
            params, state, _ = bundle.step(
                params, state,
                {k: torch.as_tensor(x, device=dev) for k, x in b.items()})
        assert embedding_backward_groups.launches - before == (
            0 if dev == "cpu" else 3)
        out[dev] = [t.cpu() for t in tree_leaves(params)]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _hotcold_stream(cfg, hp, tr, bundle, engine, steps, params0):
    """``steps`` online steps of ``bundle`` through train_ctr on the card,
    from ``params0`` (on the CPU), over a fixed event stream: chunks of 4
    (of 1, planned on the stream's worker, for an async bundle)."""
    from repro_torch.data import stream as stream_lib

    params = bundle.prepare(tree_map(lambda t: t.clone().cuda(), params0))
    events = stream_lib.synthetic_event_stream(tr, rows_per_event=300,
                                               seed=2)
    if bundle.stream_transform is not None:
        source = stream_lib.stream_chunks(
            events, 512, 1, buffer_size=4,
            transform=bundle.stream_transform(max_steps=steps))
    else:
        source = stream_lib.stream_chunks(events, 512, 4)
    return train_ctr(cfg, None, tr, None, batch_size=512,
                     step_bundle=bundle, max_steps=steps, engine=engine,
                     mode="stream", stream=source,
                     init_state=(params, bundle.init(params)))


def _tensors(tree):
    from repro_torch.core.tree import flatten_with_paths

    return {k: v.cpu() for k, v in flatten_with_paths(tree).items()
            if isinstance(v, torch.Tensor)}


@pytest.mark.cuda
@pytest.mark.parametrize("admission", ["cumulative", "decayed"])
def test_torch_hotcold_cuda_graph_equals_eager(admission):
    """The synchronous hot/cold step on the card, online over 10 steps at
    capacity 64 (evicting): eager, eager again and the scan engine's
    graphs (chunks of 4, a budget cut to 2) give the same params, state
    (hot tier, slot maps, frequencies) and losses bit for bit, and the
    CPU path's params within 1e-5; one launch of each grouped sparse
    kernel a step, none of the fused kernel."""
    _need_cuda()
    cfg, hp, ds = _small_ctr("hotcold")
    tr, _ = ds.split(0.95)
    params0 = ctr.init(cfg, seed=4, device="cpu")
    store = store_for(cfg, hot_capacity=64, admission=admission,
                      half_life=3)
    runs = {}
    for name, eng in (("eager", "eager"), ("again", "eager"),
                      ("scan", "scan")):
        for w in (sparse_gather_catchup_tables, sparse_update_scatter_tables,
                  fused_cowclip_adam):
            w.launches = 0
        runs[name] = _hotcold_stream(cfg, hp, tr, store.make_bundle(cfg, hp),
                                     eng, 10, params0)
        if name == "eager":
            assert sparse_gather_catchup_tables.launches == 10
            assert sparse_update_scatter_tables.launches == 10
            assert fused_cowclip_adam.launches == 0
    a = runs["eager"]
    for b in (runs["again"], runs["scan"]):
        assert a.steps == b.steps == 10 and a.losses == b.losses
        fa = _tensors({"p": a.params, "s": a.opt_state})
        fb = _tensors({"p": b.params, "s": b.opt_state})
        for k in fa:
            assert torch.equal(fa[k], fb[k]), k
    bundle = store.make_bundle(cfg, hp)
    params = bundle.prepare(tree_map(torch.clone, params0))
    state = bundle.init(params)
    from repro_torch.data import stream as stream_lib

    events = stream_lib.synthetic_event_stream(tr, rows_per_event=300,
                                               seed=2)
    cpu = train_ctr(cfg, None, tr, None, batch_size=512, step_bundle=bundle,
                    max_steps=10, engine="eager", mode="stream",
                    stream=stream_lib.stream_chunks(events, 512, 4),
                    init_state=(params, state), device="cpu")
    fa, fc = _tensors(a.params), _tensors(cpu.params)
    for k in fa:
        np.testing.assert_allclose(fa[k].numpy(), fc[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.cuda
def test_torch_hotcold_cuda_async_matches_sync():
    """The async cold store on the card (the planner on the stream's
    worker, plans copied from pinned memory, evictions copied back with an
    event) exports the synchronous step's params bit for bit, losses
    included, at capacity 64 over 10 steps."""
    _need_cuda()
    cfg, hp, ds = _small_ctr("hotcold")
    tr, _ = ds.split(0.95)
    params0 = ctr.init(cfg, seed=4, device="cpu")
    out = {}
    for cold in ("none", "mem"):
        bundle = store_for(cfg, hot_capacity=64, cold_store=cold
                           ).make_bundle(cfg, hp)
        res = _hotcold_stream(cfg, hp, tr, bundle, "scan", 10, params0)
        out[cold] = (res, _tensors(bundle.export(res.params)))
    assert out["none"][0].losses == out["mem"][0].losses
    for k, v in out["none"][1].items():
        assert torch.equal(v, out["mem"][1][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("admission", ["cumulative", "decayed"])
def test_torch_hotcold_cuda_guard_equals_unguarded(admission):
    """The guarded synchronous hot/cold step on the card at capacity 64
    (evicting) over 10 clean steps, eager and as graphs: the unguarded
    step's params, state (hot tier, slot maps, frequencies) and losses
    bit for bit, with the same launches a step (one of each grouped
    sparse kernel, one embedding backward run, no fused update)."""
    _need_cuda()
    cfg, hp, ds = _small_ctr("hotcold")
    tr, _ = ds.split(0.95)
    params0 = ctr.init(cfg, seed=4, device="cpu")
    store = store_for(cfg, hot_capacity=64, admission=admission,
                      half_life=3)
    runs = {}
    for guard in (False, True):
        for eng in ("eager", "scan"):
            for w in (sparse_gather_catchup_tables,
                      sparse_update_scatter_tables,
                      embedding_backward_groups, fused_cowclip_adam):
                w.launches = 0
            bundle = store.make_bundle(cfg, hp, nonfinite_guard=guard)
            runs[guard, eng] = _hotcold_stream(cfg, hp, tr, bundle, eng, 10,
                                               params0)
            if eng == "eager":
                assert sparse_gather_catchup_tables.launches == 10
                assert sparse_update_scatter_tables.launches == 10
                assert embedding_backward_groups.launches == 10
                assert fused_cowclip_adam.launches == 0
    a = runs[False, "eager"]
    for key in ((True, "eager"), (True, "scan"), (False, "scan")):
        b = runs[key]
        assert a.losses == b.losses, key
        fa = _tensors({"p": a.params, "s": a.opt_state})
        fb = _tensors({"p": b.params, "s": b.opt_state})
        for k in fa:
            assert torch.equal(fa[k], fb[k]), (key, k)


@pytest.mark.cuda
def test_torch_snapshot_cuda_resume_bitwise(tmp_path):
    """Snapshots every 4 steps of the guarded synchronous hot/cold step
    on the card (graphs of 2 steps): a fresh bundle resumed from step 4
    (its step counter a 0-dim int32 tensor back on the card) and run to
    12 equals the uninterrupted 12 steps bit for bit."""
    _need_cuda()
    from repro_torch.data import stream as stream_lib
    from repro_torch.train import snapshot as snap_lib

    cfg, hp, ds = _small_ctr("hotcold")
    tr, _ = ds.split(0.95)
    store = store_for(cfg, hot_capacity=64)
    token = snap_lib.placement_token(store)
    params0 = ctr.init(cfg, seed=4, device="cuda")

    def run(d, *, max_steps, start=0, init_state=None, bundle=None):
        bundle = bundle or store.make_bundle(cfg, hp, nonfinite_guard=True)
        mgr = snap_lib.SnapshotManager(str(d))
        last = [start]

        def cb(p, s, n):
            if n - last[0] >= 4:
                p, s = snap_lib.capture(mgr, bundle, p, s, step=n,
                                        cursor={"rows_consumed": n * 512},
                                        meta={"placement": token})
                last[0] = n
            return p, s

        if init_state is None:
            p = bundle.prepare(tree_map(torch.clone, params0))
            init_state = (p, bundle.init(p))
        events = stream_lib.skip_rows(stream_lib.synthetic_event_stream(
            tr, rows_per_event=300, seed=2), start * 512)
        return train_ctr(cfg, None, tr, None, batch_size=512,
                         step_bundle=bundle, max_steps=max_steps,
                         engine="scan", mode="stream",
                         stream=stream_lib.stream_chunks(
                             events, 512, 2, start_rows=start * 512),
                         init_state=init_state, start_step=start,
                         snapshot_cb=cb)

    whole = run(tmp_path / "a", max_steps=12)
    run(tmp_path / "b", max_steps=6)
    bundle = store.make_bundle(cfg, hp, nonfinite_guard=True)
    p, s, start, _ = snap_lib.resume(
        snap_lib.SnapshotManager(str(tmp_path / "b")), bundle,
        ctr.init(cfg, seed=5, device="cuda"), token=token)
    assert start == 4 and s["step"].is_cuda and s["step"].dtype == \
        torch.int32 and int(s["step"]) == 4
    resumed = run(tmp_path / "b", max_steps=12, start=start,
                  init_state=(p, s), bundle=bundle)
    assert whole.losses[4:] == resumed.losses
    fa = _tensors({"p": whole.params, "s": whole.opt_state})
    fb = _tensors({"p": resumed.params, "s": resumed.opt_state})
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


def _sharded_runs(placement, engine, capacity=0, steps=6, guard=False):
    """train_ctr of ``placement`` on an NCCL world of one rank (a 1x1
    grid) from the same params over the same batches: (result, the
    flushed and exported params)."""
    from repro_torch.launch import mesh as mesh_lib

    cfg, hp, ds = _small_ctr(placement)
    cfg = dataclasses.replace(cfg, unique_capacity=capacity)
    tr, _ = ds.split(0.95)
    params0 = ctr.init(cfg, seed=2, device="cuda")
    with mesh_lib.process_group("cuda"):
        grid = mesh_lib.make_ctr_mesh(1, 1, device_type="cuda")
        bundle = store_for(cfg, mesh=grid).make_bundle(
            cfg, hp, warmup_steps=3, nonfinite_guard=guard)
        params = bundle.prepare(params0)
        res = train_ctr(cfg, None, tr, None, batch_size=512, seed=0,
                        step_bundle=bundle, max_steps=steps, engine=engine,
                        scan_steps=3,
                        init_state=(params, bundle.init(params)))
        exported = bundle.export(bundle.flush(res.params,
                                              res.opt_state)[0])
        torch.cuda.synchronize()
    return res, exported


@pytest.mark.cuda
@pytest.mark.parametrize("placement,capacity", [("sharded", 0),
                                                ("sharded_sparse", 0),
                                                ("sharded_sparse", 8)])
def test_torch_sharded_cuda_nccl_graph_equals_eager(placement, capacity):
    """On an NCCL world of one rank, its collectives issued at size 1:
    eager twice and the scan engine (3 steps a CUDA graph, NCCL calls
    captured) give the same params, state and losses bit for bit; with a
    capped capacity the overflow fallback runs inside the graph and the
    count matches the eager steps'."""
    _need_cuda()
    a, ea = _sharded_runs(placement, "eager", capacity)
    b, eb = _sharded_runs(placement, "eager", capacity)
    g, eg = _sharded_runs(placement, "scan", capacity)
    assert a.losses == b.losses == g.losses
    assert a.overflow_shards == b.overflow_shards == g.overflow_shards
    assert (a.overflow_shards > 0) == (capacity > 0)
    for x, y in ((a, b), (a, g)):
        for t in (lambda r: r.params, lambda r: r.opt_state):
            fx, fy = _flat(t(x)), _flat(t(y))
            for k in fx:
                assert torch.equal(fx[k], fy[k]), k
    for e in (eb, eg):
        fx, fy = _flat(ea), _flat(e)
        for k in fx:
            assert torch.equal(fx[k], fy[k]), k


@pytest.mark.cuda
def test_torch_sharded_cuda_decayed_lookup_equals_catchup_kernel():
    """The sharded_sparse forward's inline decay and the catch-up kernel
    give the same rows bit for bit, at pending depths 0 to 1000."""
    _need_cuda()
    from repro_torch.embed import sharded as shard_lib

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, dim = 100003, 10
    w = 0.01 * torch.randn(rows, dim, generator=gen, device="cuda")
    m, v = torch.zeros_like(w), torch.zeros_like(w)
    ls = torch.randint(0, 1001, (rows,), generator=gen, device="cuda",
                       dtype=torch.int32)
    uids = torch.randperm(rows, generator=gen, device="cuda")[:8192]
    uids = torch.sort(uids).values.to(torch.int32)
    counts = torch.ones(uids.shape[0], device="cuda")
    lr, l2 = 0.08, 1e-3
    rows_out, _ = sparse_gather_catchup_tables(
        [w], [m], [v], [ls], [uids], [counts],
        step_scalars(1002, device="cuda"), lr=lr, l2=l2)
    caught = rows_out[0][0]
    plan = shard_lib.RowShardPlan(rows, 1)
    from repro_torch.core.optim import decay_factor

    got = shard_lib.decayed_lookup_partial(
        w, ls, uids, plan, 0, torch.tensor(1002, dtype=torch.int32,
                                           device="cuda"),
        decay_factor(lr, l2))
    assert torch.equal(got, caught)


@pytest.mark.cuda
@pytest.mark.parametrize("placement,capacity", [("sharded", 0),
                                                ("sharded_sparse", 0),
                                                ("sharded_sparse", 8)])
def test_torch_sharded_cuda_guard_equals_unguarded(placement, capacity):
    """On an NCCL world of one rank, 6 clean steps through the scan engine
    (3 a graph): the guarded step gives the unguarded one's params, state
    and losses bit for bit, and skips nothing."""
    _need_cuda()
    u, eu = _sharded_runs(placement, "scan", capacity)
    g, eg = _sharded_runs(placement, "scan", capacity, guard=True)
    assert u.losses == g.losses
    for x, y in ((u.params, g.params), (u.opt_state, g.opt_state),
                 (eu, eg)):
        fx, fy = _flat(x), _flat(y)
        for k in fx:
            assert torch.equal(fx[k], fy[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("placement,capacity", [("sharded", 0),
                                                ("sharded_sparse", 0),
                                                ("sharded_sparse", 8)])
def test_torch_sharded_cuda_guard_skips_inside_a_graph(placement, capacity):
    """A chunk of 3 batches whose second holds a NaN, on an NCCL world of
    one rank: the guarded eager steps skip it (every leaf bitwise
    unchanged by it) and the chunk's replay equals them bit for bit."""
    _need_cuda()
    from repro_torch.launch import mesh as mesh_lib

    cfg, hp, ds = _small_ctr(placement)
    cfg = dataclasses.replace(cfg, unique_capacity=capacity)
    host = [b for _, b in zip(range(3), iterate_batches(ds, 512, seed=1))]
    host[1]["dense"][5, 0] = np.nan
    chunk = {k: torch.as_tensor(np.stack([b[k] for b in host])).cuda()
             for k in host[0]}
    params0 = ctr.init(cfg, seed=2, device="cuda")
    with mesh_lib.process_group("cuda"):
        grid = mesh_lib.make_ctr_mesh(1, 1, device_type="cuda")
        bundle = store_for(cfg, mesh=grid).make_bundle(
            cfg, hp, warmup_steps=3, nonfinite_guard=True)
        p = bundle.prepare(tree_map(torch.clone, params0))
        s = bundle.init(p)
        skipped = []
        for i in range(3):
            before = _flat(tree_map(torch.clone, (p, s)))
            p, s, aux = bundle.step(p, s, {k: v[i] for k, v in chunk.items()})
            skipped.append(int(aux["skipped_steps"]))
            if i == 1:
                after = _flat((p, s))
                for k in before:
                    assert torch.equal(before[k], after[k]), k
        g = bundle.prepare(tree_map(torch.clone, params0))
        gs = bundle.init(g)
        runner = engine_lib.make_chunk_runner(bundle.step.scan_step)
        g, gs, aux = runner(g, gs, chunk)       # the capture, a replay
        torch.cuda.synchronize()
        assert skipped == [0, 1, 0]
        assert aux["skipped_steps"].tolist() == [0, 1, 0]
        assert int(gs["step"]) == int(s["step"]) == 2
        fx, fy = _flat((p, s)), _flat((g, gs))
        for k in fx:
            assert torch.equal(fx[k], fy[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["sharded", "sharded_sparse"])
def test_torch_sharded_cuda_snapshot_resume_bitwise(placement, tmp_path):
    """Online on an NCCL world of one rank, graphs of 2 steps, a snapshot
    every 4: a fresh bundle resumed from step 4 (its state's blocks back
    on the card) and run to 8 equals the uninterrupted 8 steps bit for
    bit."""
    _need_cuda()
    from repro_torch.data import stream as stream_lib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import snapshot as snap_lib

    cfg, hp, ds = _small_ctr(placement)
    tr, _ = ds.split(0.95)
    params0 = ctr.init(cfg, seed=4, device="cuda")
    with mesh_lib.process_group("cuda"):
        grid = mesh_lib.make_ctr_mesh(1, 1, device_type="cuda")
        store = store_for(cfg, mesh=grid, partition="mod")
        token = snap_lib.placement_token(store)

        def run(d, *, max_steps, start=0, init_state=None, bundle=None):
            bundle = bundle or store.make_bundle(cfg, hp,
                                                 nonfinite_guard=True)
            mgr = snap_lib.SnapshotManager(str(d))
            last = [start]

            def cb(p, s, n):
                if n - last[0] >= 4:
                    p, s = snap_lib.capture(
                        mgr, bundle, p, s, step=n,
                        cursor={"rows_consumed": n * 512},
                        meta={"placement": token})
                    last[0] = n
                return p, s

            if init_state is None:
                p = bundle.prepare(tree_map(torch.clone, params0))
                init_state = (p, bundle.init(p))
            events = stream_lib.skip_rows(stream_lib.synthetic_event_stream(
                tr, rows_per_event=300, seed=2), start * 512)
            return train_ctr(cfg, None, tr, None, batch_size=512,
                             step_bundle=bundle, max_steps=max_steps,
                             engine="scan", mode="stream",
                             stream=stream_lib.stream_chunks(
                                 events, 512, 2, start_rows=start * 512),
                             init_state=init_state, start_step=start,
                             snapshot_cb=cb)

        whole = run(tmp_path / "a", max_steps=8)
        run(tmp_path / "b", max_steps=4)
        bundle = store.make_bundle(cfg, hp, nonfinite_guard=True)
        p, s, start, _ = snap_lib.resume(
            snap_lib.SnapshotManager(str(tmp_path / "b")), bundle,
            ctr.init(cfg, seed=5, device="cuda"), token=token)
        assert start == 4 and s["step"].is_cuda and int(s["step"]) == 4
        assert all(t.is_cuda for t in tree_leaves(s))
        resumed = run(tmp_path / "b", max_steps=8, start=start,
                      init_state=(p, s), bundle=bundle)
        assert whole.losses[4:] == resumed.losses
        fa = _tensors({"p": whole.params, "s": whole.opt_state})
        fb = _tensors({"p": resumed.params, "s": resumed.opt_state})
        for k in fa:
            assert torch.equal(fa[k], fb[k]), k
        torch.cuda.synchronize()
