"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, the fused and sparse train steps on the card against the CPU
path, and the RWKV-6 LM's forward, prefill and decode on the card against
the CPU path.

They carry the ``cuda`` marker and skip without a CUDA device. This file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed (the card's machine); there, skip the repo's conftest,
which imports JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import dataclasses

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
                                         sparse_update_scatter)
from repro_torch.kernels.cowclip import ref as cc_ref
from repro_torch.kernels.wkv6 import (chunked_wkv6_reference,
                                      clipped_chunks,
                                      segmented_wkv6_reference, wkv6,
                                      wkv6_reference)
from repro_torch.kernels.wkv6.wkv6 import chunked_wkv6, segment_chunks
from repro_torch.models import ctr, lm, rwkv


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
        ref = reference(w, g, cnt, m, v, step, lr=1e-3, l2=1e-4)
        out = fused_cowclip_adam(w, g, cnt, m, v, step, lr=1e-3, l2=1e-4)
        torch.cuda.synchronize()
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


@pytest.mark.cuda
def test_torch_wkv6_cuda_rejects_bad_inputs():
    _need_cuda()
    inp = _wkv_inputs(1, 40, 8, seed=0)
    with pytest.raises(ValueError):
        wkv6(*inp, chunk=16)                       # ragged S
    inp = _wkv_inputs(1, 32, 8, seed=0)
    with pytest.raises(ValueError):
        wkv6(inp[0], inp[1].cpu(), *inp[2:])       # mixed devices
    inp[0].requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        wkv6(*inp)


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
