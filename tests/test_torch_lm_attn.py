"""The port's attention LMs against the JAX package, on the CPU.

The layers (rope, the causal mask, attention over a full sequence, the
cached prefill and decode, with and without a window; the three MLPs) on
JAX-initialised params, and the six attention archs at their reduced
size (``reduce_config``: 2 or 4 layers, d_model 128, 4 heads, vocab 512,
f32) with params made by JAX's ``lm.init`` and carried across by
``params_from_numpy``: the forward and loss (with a seeded frontend
prefix for musicgen-large and internvl2-26b), the cached prefill and its
decode, decode continued from JAX's own cache, a prompt longer than
gemma3's window (the ring's roll branch), and deepseek's padded heads
turned on. The bar is the LM bar of ROADMAP queue 1 item 8: max abs
difference of logits (and of every KV-cache leaf) <= 1e-4; the observed
differences are a few 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.tree import flatten_with_paths
from repro_torch.models import layers, lm
from repro_torch.serve.decode import (GraphDecoder, frontend_prefix,
                                      greedy_generate)
from repro_torch.train import checkpoint

LM_BAR = 1e-4
ATTN_ARCHS = ("stablelm-3b", "granite-20b", "deepseek-coder-33b",
              "gemma3-12b", "musicgen-large", "internvl2-26b")


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _carry(tree):
    return checkpoint.params_from_numpy(jax.tree.map(np.asarray, tree),
                                        device="cpu")


def _normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("hd", [16, 32, 256])
def test_torch_rope_matches_jax(theta, hd):
    rng = np.random.default_rng(hd)
    x = _normal(rng, (2, 5, 3, hd))
    pos = rng.integers(0, 1100, (2, 5)).astype(np.int32)
    assert _max_abs(jax_layers.rope_freqs(hd, theta),
                    layers.rope_freqs(hd, theta).numpy()) <= 1e-7
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta)
    assert got.dtype == torch.float32
    assert _max_abs(want, got.numpy()) <= LM_BAR
    # halves, not pairs: position 0 is the identity, and a rotation keeps
    # each (x1[i], x2[i]) pair's norm
    zero = layers.apply_rope(torch.from_numpy(x), torch.zeros(2, 5), theta)
    assert torch.equal(zero, torch.from_numpy(x))
    h = hd // 2
    norms = (got[..., :h] ** 2 + got[..., h:] ** 2).numpy()
    assert np.allclose(norms, x[..., :h] ** 2 + x[..., h:] ** 2, rtol=1e-5,
                       atol=1e-6)


@pytest.mark.parametrize("s_q,s_k,window", [(5, 5, None), (5, 5, 2),
                                            (1, 7, None), (3, 9, 4),
                                            (10, 10, 8)])
def test_torch_causal_mask_matches_jax(s_q, s_k, window):
    want = np.asarray(jax_layers._causal_mask(s_q, s_k, window))
    got = layers._causal_mask(s_q, s_k, window).numpy()
    assert got.dtype == np.float32 and np.array_equal(want, got)


def _attn_params(seed, d, heads, kv, hd, alloc=None):
    p = jax_layers.init_attention(jax.random.key(seed), d, heads, kv, hd,
                                  alloc)
    return p, _carry(p)


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("heads,kv,alloc", [(4, 4, None), (4, 2, None),
                                            (4, 1, None), (4, 1, 8)],
                         ids=["mha", "gqa", "mqa", "mqa_padded"])
def test_torch_attention_layers_match_jax(window, heads, kv, alloc):
    """attention_train, attention_prefill (the cache too: linear, or a
    ring shorter than the prompt) and 6 decode steps on the prefill's
    cache, against JAX's layers."""
    d, hd, s, steps = 32, 8, 7, 6
    jp, tp = _attn_params(3, d, heads, kv, hd, alloc)
    rng = np.random.default_rng(4)
    x = _normal(rng, (2, s, d))
    kw = dict(theta=1e4, window=window, n_valid_heads=heads)
    want = jax_layers.attention_train(jp, jnp.asarray(x), **kw)
    got = layers.attention_train(tp, torch.from_numpy(x), **kw)
    assert _max_abs(want, got.numpy()) <= LM_BAR

    cap = window or s + steps
    jcache = jax_layers.init_kv_cache(2, cap, kv, hd, jnp.float32)
    tcache = layers.init_kv_cache(2, cap, kv, hd, torch.float32,
                                  device="cpu")
    jy, jcache = jax_layers.attention_prefill(jp, jnp.asarray(x), jcache,
                                              **kw)
    ty, tcache = layers.attention_prefill(tp, torch.from_numpy(x), tcache,
                                          **kw)
    assert tcache.capacity == cap
    assert _max_abs(jy, ty.numpy()) <= LM_BAR
    for a, b in zip(jcache, tcache):
        assert _max_abs(a, b.numpy()) <= LM_BAR
    for t in range(s, s + steps):
        xt = _normal(rng, (2, 1, d))
        jy, jcache = jax_layers.attention_decode(
            jp, jnp.asarray(xt), jcache, jnp.asarray(t, jnp.int32), **kw)
        ty, tcache = layers.attention_decode(tp, torch.from_numpy(xt),
                                             tcache, t, **kw)
        assert _max_abs(jy, ty.numpy()) <= LM_BAR, t
        for a, b in zip(jcache, tcache):
            assert _max_abs(a, b.numpy()) <= LM_BAR, t


def test_torch_attention_decode_cursor_and_inplace():
    """A 0-dim int64 cursor tensor gives the int's result bitwise; the
    out-of-place step leaves the cache as it was, the in-place one writes
    the same cache into it."""
    jp, tp = _attn_params(5, 32, 4, 2, 8)
    rng = np.random.default_rng(6)
    cache = layers.KVCache(*(torch.from_numpy(_normal(rng, (2, 4, 2, 8)))
                             for _ in range(2)))
    x = torch.from_numpy(_normal(rng, (2, 1, 32)))
    before = [t.clone() for t in cache]
    kw = dict(theta=1e4, window=4, n_valid_heads=4)
    y_int, out_int = layers.attention_decode(tp, x, cache, 9, **kw)
    assert all(torch.equal(a, b) for a, b in zip(cache, before))
    y_t, out_t = layers.attention_decode(tp, x, cache, torch.tensor(9),
                                         inplace=True, **kw)
    assert torch.equal(y_int, y_t)
    assert out_t.k is cache.k and out_t.v is cache.v
    assert all(torch.equal(a, b) for a, b in zip(out_int, cache))
    # slot 9 % 4 == 1 took the new row; the others kept theirs
    assert torch.equal(cache.k[:, [0, 2, 3]], before[0][:, [0, 2, 3]])
    assert not torch.equal(cache.k[:, 1], before[0][:, 1])


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu"])
def test_torch_mlp_matches_jax(act):
    p = jax_layers.init_mlp(jax.random.key(7), 32, 64, act)
    assert ("w_gate" in p) is (act == "swiglu")
    x = _normal(np.random.default_rng(8), (2, 5, 32), 2.0)
    want = jax_layers.mlp(p, jnp.asarray(x), act)
    got = layers.mlp(_carry(p), torch.from_numpy(x), act)
    assert _max_abs(want, got.numpy()) <= LM_BAR
    with pytest.raises(ValueError, match="unknown act"):
        layers.mlp(_carry(p), torch.from_numpy(x), "tanh")


def test_torch_init_layers_shapes():
    """The port's own init: the reference's shapes and scales, stacked by
    ``lead``, with ``n_heads_alloc`` rows in wq / wo."""
    gen = torch.Generator().manual_seed(0)
    p = layers.init_attention(gen, 64, 6, 2, 16, 8, lead=(3,), device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "wq": (3, 64, 8, 16), "wk": (3, 64, 2, 16), "wv": (3, 64, 2, 16),
        "wo": (3, 8, 16, 64)}
    assert abs(float(p["wq"].std()) - 64 ** -0.5) < 0.01
    assert abs(float(p["wo"].std()) - (6 * 16) ** -0.5) < 0.01
    m = layers.init_mlp(gen, 64, 96, "gelu", device="cpu")
    assert sorted(m) == ["w_in", "w_out"]


# ---------------------------------------------------------------------------
# the six archs at the reduced size
# ---------------------------------------------------------------------------


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_reduce_config(jax_get_config(arch)),
                                **kw),
            dataclasses.replace(reduce_config(get_config(arch)), **kw))


_MODELS: dict = {}


def _model(arch, **kw):
    """JAX params of the reduced config and the same params in torch,
    made once a module."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(arch, **kw)
        jparams = jax_lm.init(jax.random.key(0), jcfg)
        _MODELS[key] = (jcfg, tcfg, jparams, _carry(jparams))
    return _MODELS[key]


def _inputs(cfg, batch, seq, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    prefix = (_normal(rng, (batch, cfg.n_prefix, cfg.d_model), 0.1)
              if cfg.frontend else None)
    return tokens, prefix


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _cache_flat(cache):
    return flatten_with_paths(jax.tree.map(np.asarray, cache))


def _assert_caches(jcache, tcache):
    jflat = _cache_flat(jcache)
    tflat = flatten_with_paths(checkpoint.params_to_numpy(tcache))
    assert sorted(jflat) == sorted(tflat)
    for key in jflat:
        assert jflat[key].shape == tflat[key].shape, key
        assert _max_abs(jflat[key], tflat[key]) <= LM_BAR, key


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_torch_lm_attn_forward_and_loss_match_jax(arch):
    jcfg, tcfg, jparams, tparams = _model(arch)
    tokens, prefix = _inputs(tcfg, 2, 12, seed=1)
    jl, _ = jax_lm.forward(jparams, jcfg, jnp.asarray(tokens), _j(prefix))
    tl, taux = lm.forward(tparams, tcfg, torch.from_numpy(tokens),
                          _t(prefix))
    p = tcfg.n_prefix if tcfg.frontend else 0
    assert tuple(tl.shape) == (2, p + 12, 512) and float(taux) == 0.0
    assert _max_abs(jl, tl.numpy()) <= LM_BAR
    jloss, jparts = jax_lm.loss_fn(jparams, jcfg, jnp.asarray(tokens),
                                   _j(prefix))
    tloss, tparts = lm.loss_fn(tparams, tcfg, torch.from_numpy(tokens),
                               _t(prefix))
    assert abs(float(jloss) - tloss.item()) <= LM_BAR
    assert abs(float(jparts["ce"]) - tparts["ce"].item()) <= LM_BAR
    want = jax_lm.prefill(jparams, jcfg, jnp.asarray(tokens), _j(prefix))
    got = lm.prefill(tparams, tcfg, torch.from_numpy(tokens), _t(prefix))
    assert _max_abs(want, got.numpy()) <= LM_BAR


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_torch_lm_attn_cached_prefill_and_decode_match_jax(arch):
    """The prefill's last logits, cur_index (P + S) and every KV leaf, then
    6 decode steps fed JAX's greedy tokens, compared on logits and on the
    caches after them."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    tokens, prefix = _inputs(tcfg, 2, 6, seed=2)
    max_len = (tcfg.n_prefix if tcfg.frontend else 0) + 12
    jl, jcache, jcur = jax_lm.prefill_with_cache(
        jparams, jcfg, jnp.asarray(tokens), max_len, _j(prefix))
    tl, tcache, tcur = lm.prefill_with_cache(
        tparams, tcfg, torch.from_numpy(tokens), max_len, _t(prefix))
    assert int(jcur) == tcur == max_len - 6
    assert _max_abs(jl, tl.numpy()) <= LM_BAR
    _assert_caches(jcache, tcache)
    tok = jnp.argmax(jl, axis=-1)
    for step in range(6):
        jl, jcache = jax_lm.decode_step(jparams, jcfg, tok, jcache,
                                        jnp.asarray(tcur + step, jnp.int32))
        tl, tcache = lm.decode_step(tparams, tcfg,
                                    torch.from_numpy(np.array(tok)), tcache,
                                    tcur + step)
        assert _max_abs(jl, tl.numpy()) <= LM_BAR, step
        tok = jnp.argmax(jl, axis=-1)
    _assert_caches(jcache, tcache)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_torch_lm_attn_decodes_from_jax_cache(arch):
    """A JAX decode cache comes across with ``params_from_numpy`` and a
    template (its ``KVCache`` leaves), and the port's decode continues it,
    in place and out of place alike."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    tokens, prefix = _inputs(tcfg, 2, 5, seed=3)
    max_len = (tcfg.n_prefix if tcfg.frontend else 0) + 9
    jl, jcache, jcur = jax_lm.prefill_with_cache(
        jparams, jcfg, jnp.asarray(tokens), max_len, _j(prefix))
    template = lm.init_cache(tcfg, 2, max_len, device="cpu")
    cache = checkpoint.params_from_numpy(jax.tree.map(np.asarray, jcache),
                                         device="cpu", template=template)
    assert type(cache["pos_0"]) is layers.KVCache
    tok = jnp.argmax(jl, axis=-1)
    for step in range(3):
        cur = int(jcur) + step
        jl, jcache = jax_lm.decode_step(jparams, jcfg, tok, jcache,
                                        jnp.asarray(cur, jnp.int32))
        ttok = torch.from_numpy(np.array(tok))
        out, copied = lm.decode_step(tparams, tcfg, ttok, cache, cur)
        got, same = lm.decode_step(tparams, tcfg, ttok, cache,
                                   torch.tensor(cur), inplace=True)
        assert same is cache and torch.equal(out, got)
        assert all(torch.equal(a, b) for a, b in zip(
            flatten_with_paths(copied).values(),
            flatten_with_paths(cache).values()))
        assert _max_abs(jl, got.numpy()) <= LM_BAR, step
        tok = jnp.argmax(jl, axis=-1)
    _assert_caches(jcache, cache)


@pytest.mark.parametrize("seq,new", [(10, 12), (8, 3), (17, 2)])
def test_torch_lm_gemma3_ring_longer_than_window(seq, new):
    """Reduced gemma3 (window 8; a local and a global layer, each twice):
    a prompt of 10 or 17 tokens fills the local ring through the roll
    branch, 8 exactly fills it; decode then wraps the ring. Against JAX,
    and against the full forward over prompt + fed tokens within the
    reference's own decode-vs-forward bar (5e-3)."""
    jcfg, tcfg, jparams, tparams = _model("gemma3-12b")
    assert tcfg.window == 8 and tcfg.block_pattern == ("local", "attn")
    tokens, _ = _inputs(tcfg, 2, seq + new, seed=4)
    prompt, fed = tokens[:, :seq], tokens[:, seq:]
    max_len = seq + new
    jl, jcache, _ = jax_lm.prefill_with_cache(jparams, jcfg,
                                              jnp.asarray(prompt), max_len)
    tl, tcache, cur = lm.prefill_with_cache(tparams, tcfg,
                                            torch.from_numpy(prompt),
                                            max_len)
    assert tcache["pos_0"].k.shape[2] == 8                      # the ring
    assert tcache["pos_1"].k.shape[2] == max_len                # linear
    assert _max_abs(jl, tl.numpy()) <= LM_BAR
    _assert_caches(jcache, tcache)
    outs = [tl]
    for i in range(new):
        jl, jcache = jax_lm.decode_step(jparams, jcfg, jnp.asarray(fed[:, i]),
                                        jcache, jnp.asarray(cur + i,
                                                            jnp.int32))
        tl, tcache = lm.decode_step(tparams, tcfg, torch.from_numpy(fed[:, i]),
                                    tcache, cur + i, inplace=True)
        assert _max_abs(jl, tl.numpy()) <= LM_BAR, i
        outs.append(tl)
    _assert_caches(jcache, tcache)
    full, _ = lm.forward(tparams, tcfg, torch.from_numpy(tokens))
    got = torch.stack(outs[:-1] if new else outs, dim=1)
    assert _max_abs(full[:, seq - 1:seq - 1 + got.shape[1]], got) <= 5e-3


@pytest.mark.parametrize("pad", [8, 16])
def test_torch_lm_padded_heads_match_jax(pad):
    """deepseek-coder-33b's ``pad_attn_heads`` (off in ``reduce_config``)
    turned on: 4 query heads allocated as 8 or 16, the padded ones masked
    to zero. Forward, cached prefill and decode against JAX; and the
    padded heads' weights do not matter."""
    jcfg, tcfg, jparams, tparams = _model("deepseek-coder-33b",
                                          pad_attn_heads=pad)
    assert tcfg.n_heads_alloc == pad == jcfg.n_heads_alloc
    assert tparams["dense"]["blocks"]["pos_0"]["attn"]["wq"].shape == (
        2, 128, pad, 32)
    tokens, _ = _inputs(tcfg, 2, 9, seed=5)
    jl, _ = jax_lm.forward(jparams, jcfg, jnp.asarray(tokens))
    tl, _ = lm.forward(tparams, tcfg, torch.from_numpy(tokens))
    assert _max_abs(jl, tl.numpy()) <= LM_BAR
    jl, jcache, _ = jax_lm.prefill_with_cache(jparams, jcfg,
                                              jnp.asarray(tokens[:, :6]), 9)
    tl, tcache, cur = lm.prefill_with_cache(tparams, tcfg,
                                            torch.from_numpy(tokens[:, :6]),
                                            9)
    assert _max_abs(jl, tl.numpy()) <= LM_BAR
    for i in range(3):
        jl, jcache = jax_lm.decode_step(jparams, jcfg,
                                        jnp.asarray(tokens[:, 6 + i]),
                                        jcache, jnp.asarray(6 + i, jnp.int32))
        tl, tcache = lm.decode_step(tparams, tcfg,
                                    torch.from_numpy(tokens[:, 6 + i]),
                                    tcache, cur + i)
        assert _max_abs(jl, tl.numpy()) <= LM_BAR, i
    _assert_caches(jcache, tcache)
    noisy = checkpoint.params_from_numpy(
        checkpoint.params_to_numpy(tparams), device="cpu")
    attn = noisy["dense"]["blocks"]["pos_0"]["attn"]
    attn["wq"][:, :, 4:] = 7.0
    attn["wo"][:, 4:] = -3.0
    again, _ = lm.forward(noisy, tcfg, torch.from_numpy(tokens))
    want, _ = lm.forward(tparams, tcfg, torch.from_numpy(tokens))
    assert torch.equal(again, want)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_torch_lm_attn_param_counts_match_jax(arch):
    """JAX's counts, at full width and reduced, from params on the meta
    device (gemma3-12b's 12,772,028,160 would be 51 GB allocated)."""
    for tcfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                       _cfgs(arch)[::-1]):
        assert lm.param_counts(tcfg) == jax_lm.param_counts(jcfg)
    if arch == "gemma3-12b":
        assert lm.param_counts(get_config(arch))["total"] == 12_772_028_160


@pytest.mark.parametrize("arch", ["gemma3-12b", "internvl2-26b"])
def test_torch_lm_attn_greedy_generate(arch):
    """The serving loop with a KV cache (and internvl2's prefix): its
    prefill logits are JAX's; every token is the argmax of the step fed
    the one before, run out of place from a fresh prefill."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    prompt, _ = _inputs(tcfg, 3, 7, seed=6)
    prefix = frontend_prefix(tcfg, 3, seed=2, device="cpu")
    assert (prefix is None) is (not tcfg.frontend)
    res = greedy_generate(tparams, tcfg, torch.from_numpy(prompt), 6,
                          prefix_emb=prefix)
    p = tcfg.n_prefix if tcfg.frontend else 0
    jl, _, _ = jax_lm.prefill_with_cache(
        jparams, jcfg, jnp.asarray(prompt), p + 13,
        None if prefix is None else jnp.asarray(prefix.numpy()))
    assert _max_abs(jl, res.prefill_logits.numpy()) <= LM_BAR
    assert tuple(res.tokens.shape) == (3, 6)
    assert torch.equal(res.tokens[:, 0], res.prefill_logits.argmax(-1))
    _, cache, cur = lm.prefill_with_cache(tparams, tcfg,
                                          torch.from_numpy(prompt), p + 13,
                                          prefix)
    assert cur == p + 7
    for i in range(6):
        logits, cache = lm.decode_step(tparams, tcfg, res.tokens[:, i],
                                       cache, cur + i)
        if i < 5:
            assert torch.equal(res.tokens[:, i + 1], logits.argmax(-1))
    assert torch.equal(logits, res.logits)


def test_torch_graph_decoder_keys():
    """A KV cache's graph is keyed by (batch, max_len); a recurrent
    state's by the batch alone."""
    _, gemma, _, _ = _model("gemma3-12b")
    assert GraphDecoder({}, gemma).key(3, 40) == (3, 40)
    rwkv = reduce_config(get_config("rwkv6-7b"))
    assert GraphDecoder({}, rwkv).key(3, 40) == (3, None)
    assert lm.has_kv_cache(gemma) and not lm.has_kv_cache(rwkv)
