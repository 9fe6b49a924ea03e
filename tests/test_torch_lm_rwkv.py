"""The port's RWKV-6 LM serving path against the JAX package, on the CPU.

``reduce_config(rwkv6-7b)`` (2 layers, d_model 128, 4 heads of 32, vocab
512, f32) with params made by JAX's ``lm.init`` and carried across by
``params_from_numpy``; the same tokens through both packages. The bar is
the LM bar of ROADMAP queue 1 item 8: max abs difference of logits (and of
every decode-cache leaf) <= 1e-4. The observed differences are about 1e-5
(f32; the reductions run in another order).
"""

import dataclasses
import resource

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_MODULES as JAX_ARCH_MODULES
from repro.configs import base as jax_base
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.data.synthetic import make_lm_tokens as jax_make_lm_tokens
from repro.models import lm as jax_lm
from repro_torch.configs import (ARCH_MODULES, ASSIGNED_ARCHS, INPUT_SHAPES,
                                 get_config, reduce_config,
                                 supports_long_context)
from repro_torch.core.tree import flatten_with_paths
from repro_torch.data import make_lm_tokens
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models import lm
from repro_torch.serve.decode import greedy_generate
from repro_torch.train import checkpoint

LM_BAR = 1e-4


def _cfgs(**kw):
    jcfg = dataclasses.replace(jax_reduce_config(jax_get_config("rwkv6-7b")),
                               **kw)
    tcfg = dataclasses.replace(reduce_config(get_config("rwkv6-7b")), **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def model():
    """JAX params of the reduced config, and the same params in torch."""
    jcfg, tcfg = _cfgs()
    jparams = jax_lm.init(jax.random.key(0), jcfg)
    tparams = checkpoint.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(batch, seq, seed, vocab=512):
    return make_lm_tokens(batch * seq, vocab, seed=seed).reshape(batch, seq)


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


LM_ARCHS = ASSIGNED_ARCHS


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_torch_lm_config_letter_for_letter(arch):
    full = get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jax_get_config(arch))
    jcfg = jax_reduce_config(jax_get_config(arch))
    tcfg = reduce_config(full)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.vocab_size,
            tcfg.compute_dtype) == (2 * len(tcfg.block_pattern), 128, 4,
                                    512, "float32")
    assert tcfg.dtype is torch.float32 and full.dtype is torch.bfloat16
    assert (tcfg.hd, tcfg.n_heads_alloc) == (jcfg.hd, jcfg.n_heads_alloc)
    assert (full.hd, full.n_heads_alloc, full.padded_vocab) == (
        jax_get_config(arch).hd, jax_get_config(arch).n_heads_alloc,
        jax_get_config(arch).padded_vocab)
    assert INPUT_SHAPES == jax_base.INPUT_SHAPES
    assert supports_long_context(full) is jax_base.supports_long_context(
        jax_get_config(arch))
    assert ARCH_MODULES == JAX_ARCH_MODULES


def test_torch_lm_params_carry_stacked_tree(model, tmp_path):
    """JAX's stacked ``[n_repeats, ...]`` tree has the port's init's keys
    and shapes, and survives an npz round trip through both packages'
    key format."""
    _, tcfg, jparams, tparams = model
    own = flatten_with_paths(lm.init(tcfg, seed=0, device="cpu"))
    carried = flatten_with_paths(tparams)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in carried.items()}
    assert carried["dense/blocks/pos_0/att/wr"].shape == (2, 128, 128)
    path = tmp_path / "lm.npz"
    checkpoint.save(str(path), tparams)
    back = flatten_with_paths(checkpoint.params_from_numpy(str(path),
                                                           device="cpu"))
    assert all(torch.equal(back[k], carried[k]) for k in carried)
    jflat = flatten_with_paths(jax.tree.map(np.asarray, jparams))
    assert sorted(jflat) == sorted(carried)


@pytest.mark.parametrize("backend", ["scan", "chunked"])
def test_torch_lm_forward_and_loss_match_jax(model, backend):
    jcfg, tcfg, jparams, tparams = model
    jcfg = dataclasses.replace(jcfg, wkv_backend=backend)
    tcfg = dataclasses.replace(tcfg, wkv_backend=backend)
    tokens = _tokens(2, 32, seed=3)
    jl, jaux = jax_lm.forward(jparams, jcfg, jnp.asarray(tokens))
    tl, taux = lm.forward(tparams, tcfg, torch.from_numpy(tokens))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 32, 512)
    assert _max_abs(jl, tl.numpy()) <= LM_BAR
    assert float(taux) == float(jaux) == 0.0
    jloss, jparts = jax_lm.loss_fn(jparams, jcfg, jnp.asarray(tokens))
    tloss, tparts = lm.loss_fn(tparams, tcfg, torch.from_numpy(tokens))
    assert abs(float(jloss) - tloss.item()) <= LM_BAR
    assert abs(float(jparts["ce"]) - tparts["ce"].item()) <= LM_BAR


def test_torch_lm_prefill_matches_jax(model):
    jcfg, tcfg, jparams, tparams = model
    tokens = _tokens(2, 48, seed=4)
    for backend in ("scan", "chunked"):
        want = jax_lm.prefill(jparams, dataclasses.replace(
            jcfg, wkv_backend=backend), jnp.asarray(tokens))
        got = lm.prefill(tparams, dataclasses.replace(
            tcfg, wkv_backend=backend), torch.from_numpy(tokens))
        assert tuple(got.shape) == (2, 512)
        assert _max_abs(want, got.numpy()) <= LM_BAR


def _jax_cache_flat(cache):
    return flatten_with_paths(jax.tree.map(np.asarray, cache))


def test_torch_lm_cached_prefill_and_decode_match_jax(model):
    """Last logits and every cache leaf (x_prev, s, x_prev_ffn, stacked
    per repeat) after the prefill; then 8 decode steps fed the JAX run's
    greedy tokens, compared on logits (not argmax, so a tie cannot flip
    the test)."""
    jcfg, tcfg, jparams, tparams = model
    tokens = _tokens(2, 32, seed=5)
    jl, jcache, jcur = jax_lm.prefill_with_cache(jparams, jcfg,
                                                 jnp.asarray(tokens), 40)
    tl, tcache, tcur = lm.prefill_with_cache(tparams, tcfg,
                                             torch.from_numpy(tokens), 40)
    assert int(jcur) == tcur == 32
    assert _max_abs(jl, tl.numpy()) <= LM_BAR
    jflat = _jax_cache_flat(jcache)
    tflat = flatten_with_paths(checkpoint.params_to_numpy(tcache))
    assert sorted(tflat) == sorted(jflat) == [
        "pos_0/s", "pos_0/x_prev", "pos_0/x_prev_ffn"]
    assert tflat["pos_0/s"].shape == (2, 2, 4, 32, 32)
    for key in jflat:
        assert _max_abs(jflat[key], tflat[key]) <= LM_BAR, key

    tok = jnp.argmax(jl, axis=-1)
    for step in range(8):
        jl, jcache = jax_lm.decode_step(jparams, jcfg, tok, jcache,
                                        jnp.asarray(32 + step, jnp.int32))
        tl, tcache = lm.decode_step(tparams, tcfg,
                                    torch.from_numpy(np.array(tok)), tcache,
                                    32 + step)
        assert _max_abs(jl, tl.numpy()) <= LM_BAR, step
        tok = jnp.argmax(jl, axis=-1)
    jflat, tflat = _jax_cache_flat(jcache), flatten_with_paths(
        checkpoint.params_to_numpy(tcache))
    assert all(_max_abs(jflat[k], tflat[k]) <= LM_BAR for k in jflat)


def test_torch_lm_decodes_from_jax_cache(model):
    """A JAX decode cache comes across with ``params_from_numpy`` and a
    template (its RWKVState leaves), and the port's decode continues it."""
    jcfg, tcfg, jparams, tparams = model
    tokens = _tokens(2, 16, seed=6)
    jl, jcache, _ = jax_lm.prefill_with_cache(jparams, jcfg,
                                              jnp.asarray(tokens), 24)
    template = lm.init_cache(tcfg, 2, 24, device="cpu")
    cache = checkpoint.params_from_numpy(jax.tree.map(np.asarray, jcache),
                                         device="cpu", template=template)
    assert type(cache["pos_0"]) is type(template["pos_0"])
    tok = jnp.argmax(jl, axis=-1)
    want, _ = jax_lm.decode_step(jparams, jcfg, tok, jcache,
                                 jnp.asarray(16, jnp.int32))
    got, _ = lm.decode_step(tparams, tcfg, torch.from_numpy(np.array(tok)),
                            cache, 16)
    assert _max_abs(want, got.numpy()) <= LM_BAR


def test_torch_lm_greedy_generate(model):
    """The serving loop: its prefill logits are JAX's, its first token is
    their argmax, and every later token the argmax of the decode step fed
    the one before."""
    jcfg, tcfg, jparams, tparams = model
    prompt = _tokens(3, 16, seed=7)
    res = greedy_generate(tparams, tcfg, torch.from_numpy(prompt), 6)
    jl, _, _ = jax_lm.prefill_with_cache(jparams, jcfg, jnp.asarray(prompt),
                                         22)
    assert _max_abs(jl, res.prefill_logits.numpy()) <= LM_BAR
    assert tuple(res.tokens.shape) == (3, 6)
    assert torch.equal(res.tokens[:, 0], res.prefill_logits.argmax(-1))
    _, cache, cur = lm.prefill_with_cache(tparams, tcfg,
                                          torch.from_numpy(prompt), 22)
    for i in range(6):
        logits, cache = lm.decode_step(tparams, tcfg, res.tokens[:, i], cache,
                                       cur + i)
        if i < 5:
            assert torch.equal(res.tokens[:, i + 1], logits.argmax(-1))
    assert torch.equal(logits, res.logits)


def _count_wkv6(monkeypatch):
    calls = []
    monkeypatch.setattr("repro_torch.models.rwkv.wkv6",
                        lambda *a, **k: calls.append(1) or wkv6(*a, **k))
    return calls


def test_torch_lm_ragged_chunked_falls_back_to_scan(model, monkeypatch):
    """Length 23 is no multiple of the chunk. JAX's chunked backend falls
    back to the token scan there; the port's pads the sequence to a whole
    chunk and still calls the wkv6 wrapper once per layer (on the card, the
    kernel). Its logits match the port's scan and JAX's at the LM bar."""
    jcfg, tcfg, jparams, tparams = model
    tokens = _tokens(2, 23, seed=8)
    chunked = dataclasses.replace(tcfg, wkv_backend="chunked")
    calls = _count_wkv6(monkeypatch)
    got, _ = lm.forward(tparams, chunked, torch.from_numpy(tokens))
    assert len(calls) == tcfg.n_layers
    scan, _ = lm.forward(tparams, tcfg, torch.from_numpy(tokens))
    assert _max_abs(got, scan) <= LM_BAR
    want, _ = jax_lm.forward(jparams, dataclasses.replace(
        jcfg, wkv_backend="chunked"), jnp.asarray(tokens))
    assert _max_abs(want, got.numpy()) <= LM_BAR


@pytest.mark.parametrize("seq", [32, 23])
def test_torch_lm_chunked_cached_prefill_matches_jax(model, seq,
                                                     monkeypatch):
    """The serving prefill through the chunked backend (one wrapper call
    per layer, a ragged length padded) hands decode the kernel's final
    state. JAX's handoff always runs the exact scan: the last logits and
    every cache leaf agree with it at the LM bar, and so do 4 decode steps
    continued from the two caches."""
    jcfg, tcfg, jparams, tparams = model
    tokens = _tokens(2, seq, seed=9)
    chunked = dataclasses.replace(tcfg, wkv_backend="chunked")
    calls = _count_wkv6(monkeypatch)
    tl, tcache, tcur = lm.prefill_with_cache(tparams, chunked,
                                             torch.from_numpy(tokens), seq + 4)
    assert len(calls) == tcfg.n_layers and tcur == seq
    jl, jcache, _ = jax_lm.prefill_with_cache(
        jparams, dataclasses.replace(jcfg, wkv_backend="chunked"),
        jnp.asarray(tokens), seq + 4)
    assert _max_abs(jl, tl.numpy()) <= LM_BAR
    jflat = _jax_cache_flat(jcache)
    tflat = flatten_with_paths(checkpoint.params_to_numpy(tcache))
    for key in jflat:
        assert _max_abs(jflat[key], tflat[key]) <= LM_BAR, key
    tok = jnp.argmax(jl, axis=-1)
    for step in range(4):
        jl, jcache = jax_lm.decode_step(jparams, jcfg, tok, jcache,
                                        jnp.asarray(seq + step, jnp.int32))
        tl, tcache = lm.decode_step(tparams, chunked,
                                    torch.from_numpy(np.array(tok)), tcache,
                                    seq + step)
        assert _max_abs(jl, tl.numpy()) <= LM_BAR, step
        tok = jnp.argmax(jl, axis=-1)


def test_torch_lm_masks_pad_vocab():
    """vocab 500 pads to 512; the pad logits are -1e30 in the forward, the
    cached prefill and decode, as in JAX."""
    jcfg, tcfg = _cfgs(vocab_size=500)
    assert tcfg.padded_vocab == 512
    jparams = jax_lm.init(jax.random.key(1), jcfg)
    tparams = checkpoint.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                           device="cpu")
    tokens = _tokens(2, 16, seed=9, vocab=500)
    jl, _ = jax_lm.forward(jparams, jcfg, jnp.asarray(tokens))
    tl, _ = lm.forward(tparams, tcfg, torch.from_numpy(tokens))
    assert bool((tl[..., 500:] == -1e30).all())
    assert _max_abs(jl, tl.numpy()) <= LM_BAR
    last, cache, cur = lm.prefill_with_cache(tparams, tcfg,
                                             torch.from_numpy(tokens), 17)
    step, _ = lm.decode_step(tparams, tcfg, last.argmax(-1), cache, cur)
    for logits in (last, step):
        assert bool((logits[:, 500:] == -1e30).all())
        assert int(logits.argmax(-1).max()) < 500


def test_torch_lm_param_counts_without_allocating():
    """JAX's counts, reduced and at full width (7,534,546,944), from params
    on the meta device: building the full-width tree adds no resident
    memory (30 GB if it allocated)."""
    for arch_cfg, jax_cfg in ((reduce_config(get_config("rwkv6-7b")),
                               jax_reduce_config(jax_get_config("rwkv6-7b"))),
                              (get_config("rwkv6-7b"),
                               jax_get_config("rwkv6-7b"))):
        before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        got = lm.param_counts(arch_cfg)
        grown_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
        assert got == jax_lm.param_counts(jax_cfg)
        assert grown_kib < 1 << 20
    assert got["total"] == 7_534_546_944
    meta = lm.init(get_config("rwkv6-7b"), device="meta")
    assert meta["dense"]["blocks"]["pos_0"]["ffn"]["wk"].device.type == "meta"


@pytest.mark.parametrize("n,vocab,seed", [(1000, 512, 0), (4096, 65536, 3),
                                          (77, 7, 11)])
def test_torch_make_lm_tokens_bitwise(n, vocab, seed):
    got = make_lm_tokens(n, vocab, seed=seed)
    want = jax_make_lm_tokens(n, vocab, seed=seed)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


def test_torch_lm_every_arch_resolves_and_inits():
    """All ten assigned LM archs resolve and init on the meta device, at
    full size and reduced (llama4-scout's 102,235,345,920 parameters
    allocate nothing); an unknown block kind still raises ValueError, an
    unknown arch KeyError."""
    assert len(ASSIGNED_ARCHS) == 10
    for arch in ASSIGNED_ARCHS:
        for cfg in (get_config(arch), reduce_config(get_config(arch))):
            params = lm.init(cfg, device="meta")
            assert params["embed"]["tokens"].device.type == "meta"
            assert sorted(params["dense"]["blocks"]) == [
                f"pos_{i}" for i in range(len(cfg.block_pattern))]
            assert ("shared" in params["dense"]) is cfg.shared_attn
    assert get_config("deepfm-criteo").name == "deepfm"
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    cfg = reduce_config(get_config("rwkv6-7b"))
    for other in (dict(block_pattern=("mamba3",)),
                  dict(block_pattern=("attn", "conv"), n_layers=4)):
        with pytest.raises(ValueError, match="unknown block kind"):
            lm.init(dataclasses.replace(cfg, **other), device="cpu")
