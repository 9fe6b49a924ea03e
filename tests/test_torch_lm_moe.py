"""The port's MoE FFN and the two MoE archs (granite-moe-3b-a800m,
llama4-scout-17b-a16e) against the JAX package, on the CPU.

``moe_ffn`` on JAX-initialised params for top-1 and top-2 routing, the
SwiGLU and GELU experts, at capacity factor 8.0 (nothing dropped) and at
one that drops, and the JAX package's own overflow case (capacity 1);
decode's groups of one token never drop. Then both archs at
``reduce_config`` (attention + MoE layers, 4 experts top <= 2, capacity
factor 8.0, d_model 128, f32) with params made by JAX's ``lm.init``:
forward and loss with the MoE aux, the cached prefill and its decode,
decode continued from JAX's cache, param counts (total and active; full
size on the meta device) and the serving loop. The bar is the LM bar of
ROADMAP queue 1 item 8: max abs difference of logits (and of the aux, and
of every KV leaf) <= 1e-4. The JAX functions are jitted (``cfg`` static)
so each shape compiles once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import lm as jax_lm
from repro.models import moe as jax_moe
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.tree import flatten_with_paths
from repro_torch.models import lm, moe
from repro_torch.serve.decode import GraphDecoder, greedy_generate
from repro_torch.train import checkpoint

LM_BAR = 1e-4
MOE_ARCHS = ("granite-moe-3b-a800m", "llama4-scout-17b-a16e")

_forward = jax.jit(jax_lm.forward, static_argnums=(1,))
_loss = jax.jit(jax_lm.loss_fn, static_argnums=(1,))
_prefill = jax.jit(jax_lm.prefill_with_cache, static_argnums=(1, 3))
_decode = jax.jit(jax_lm.decode_step, static_argnums=(1,))
_moe_ffn = jax.jit(jax_moe.moe_ffn, static_argnums=(2, 3))


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _carry(tree):
    return checkpoint.params_from_numpy(jax.tree.map(np.asarray, tree),
                                        device="cpu")


def _assert_trees(jtree, ttree):
    jflat = flatten_with_paths(jax.tree.map(np.asarray, jtree))
    tflat = flatten_with_paths(checkpoint.params_to_numpy(ttree))
    assert sorted(jflat) == sorted(tflat)
    for key in jflat:
        assert jflat[key].shape == tflat[key].shape, key
        assert _max_abs(jflat[key], tflat[key]) <= LM_BAR, key


def _overflow(params, x, cfg):
    """Whether some group routes more choices to an expert than its
    capacity (from the port's router, which the JAX one agrees with)."""
    probs = torch.softmax(torch.from_numpy(x) @ params["router"], dim=-1)
    top_e = torch.topk(probs, cfg.top_k, dim=-1).indices
    counts = moe._expert_counts(top_e.reshape(x.shape[0], -1),
                                cfg.n_experts)
    return bool((counts > moe.capacity(x.shape[1], cfg)).any())


# ---------------------------------------------------------------------------
# the FFN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("factor", [8.0, 0.5], ids=["no_drop", "drop"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_torch_moe_ffn_matches_jax(top_k, act, factor):
    """Output and aux against JAX for 3 groups of 10 tokens over 4
    experts; at factor 0.5 the capacity (2 or 5 slots) overflows."""
    jcfg = jax_moe.MoEConfig(n_experts=4, top_k=top_k,
                             capacity_factor=factor)
    tcfg = moe.MoEConfig(n_experts=4, top_k=top_k, capacity_factor=factor)
    assert moe.capacity(10, tcfg) == jax_moe.capacity(10, jcfg)
    jp = jax_moe.init_moe(jax.random.key(top_k), 16, 24, jcfg, act)
    tp = _carry(jp)
    assert sorted(tp) == sorted(moe.init_moe(
        torch.Generator().manual_seed(0), 16, 24, tcfg, act, device="cpu"))
    x = np.random.default_rng(top_k).standard_normal(
        (3, 10, 16)).astype(np.float32)
    jy, jaux = _moe_ffn(jp, jnp.asarray(x), jcfg, act)
    ty, taux = moe.moe_ffn(tp, torch.from_numpy(x), tcfg, act)
    assert ty.dtype == torch.float32 and taux.dtype == torch.float32
    assert _max_abs(jy, ty.numpy()) <= LM_BAR
    assert abs(float(jaux) - taux.item()) <= LM_BAR
    assert _overflow(tp, x, tcfg) is (factor < 1)


def test_torch_moe_capacity_one_drops_overflow():
    """The JAX package's overflow case: 2 experts top-1, capacity 1, 16
    tokens; at most one token an expert survives, the rest are exactly
    zero, as in JAX."""
    jcfg = jax_moe.MoEConfig(n_experts=2, top_k=1, capacity_factor=2 / 16)
    tcfg = moe.MoEConfig(n_experts=2, top_k=1, capacity_factor=2 / 16)
    assert moe.capacity(16, tcfg) == 1
    jp = jax_moe.init_moe(jax.random.key(0), 8, 16, jcfg, "swiglu")
    x = np.array(jax.random.normal(jax.random.key(1), (1, 16, 8)))
    jy, jaux = _moe_ffn(jp, jnp.asarray(x), jcfg, "swiglu")
    ty, taux = moe.moe_ffn(_carry(jp), torch.from_numpy(x), tcfg, "swiglu")
    assert _max_abs(jy, ty.numpy()) <= LM_BAR
    assert abs(float(jaux) - taux.item()) <= LM_BAR
    zero = (ty[0].norm(dim=-1) == 0).numpy()
    assert zero.sum() >= 14
    assert np.array_equal(zero, np.linalg.norm(np.asarray(jy[0]), axis=-1)
                          == 0)


def test_torch_moe_decode_groups_never_drop():
    """A decode step is B groups of one token: the capacity is top_k and
    a token's k experts are distinct, so the config's 1.25 drops nothing:
    the result equals a capacity that cannot drop."""
    cfg = moe.MoEConfig(n_experts=40, top_k=8, capacity_factor=1.25)
    assert moe.capacity(1, cfg) == 8
    p = moe.init_moe(torch.Generator().manual_seed(1), 16, 8, cfg,
                     device="cpu")
    x = torch.randn((5, 1, 16), generator=torch.Generator().manual_seed(2))
    y, _ = moe.moe_ffn(p, x, cfg)
    ample, _ = moe.moe_ffn(p, x, dataclasses.replace(cfg,
                                                     capacity_factor=40.0))
    assert torch.allclose(y, ample, rtol=1e-6, atol=1e-7)
    assert not _overflow(p, x.numpy(), cfg)


# ---------------------------------------------------------------------------
# the two MoE archs at the reduced size
# ---------------------------------------------------------------------------


_MODELS: dict = {}


def _model(arch):
    """JAX params of the reduced config and the same params in torch,
    made once a module."""
    if arch not in _MODELS:
        jcfg = jax_reduce_config(jax_get_config(arch))
        tcfg = reduce_config(get_config(arch))
        jparams = jax.jit(jax_lm.init, static_argnums=(1,))(
            jax.random.key(0), jcfg)
        _MODELS[arch] = (jcfg, tcfg, jparams, _carry(jparams))
    return _MODELS[arch]


def _tokens(batch, seq, seed):
    return np.random.default_rng(seed).integers(
        0, 512, (batch, seq)).astype(np.int32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_torch_lm_moe_forward_and_loss_match_jax(arch):
    """Logits, the summed MoE aux, loss = ce + aux, and the score-only
    prefill."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    assert tcfg.moe == moe.MoEConfig(n_experts=4,
                                     top_k=min(2, tcfg.moe.top_k),
                                     capacity_factor=8.0)
    tokens = _tokens(2, 12, seed=1)
    jl, jaux = _forward(jparams, jcfg, jnp.asarray(tokens))
    tl, taux = lm.forward(tparams, tcfg, torch.from_numpy(tokens))
    assert tuple(tl.shape) == (2, 12, 512) and float(taux) > 0.0
    assert _max_abs(jl, tl.numpy()) <= LM_BAR
    assert abs(float(jaux) - taux.item()) <= LM_BAR
    jloss, jparts = _loss(jparams, jcfg, jnp.asarray(tokens))
    tloss, tparts = lm.loss_fn(tparams, tcfg, torch.from_numpy(tokens))
    assert abs(float(jloss) - tloss.item()) <= LM_BAR
    assert abs(float(jparts["aux"]) - tparts["aux"].item()) <= LM_BAR
    assert torch.equal(tloss, tparts["ce"] + tparts["aux"])
    got = lm.prefill(tparams, tcfg, torch.from_numpy(tokens))
    assert _max_abs(jl[:, -1], got.numpy()) <= LM_BAR


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_torch_lm_moe_cached_prefill_and_decode_match_jax(arch):
    """The prefill's last logits and KV leaves, then 6 decode steps fed
    JAX's greedy tokens (each a group of one token a row), on logits and
    on the caches."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    tokens = _tokens(2, 6, seed=2)
    jl, jcache, jcur = _prefill(jparams, jcfg, jnp.asarray(tokens), 12)
    tl, tcache, tcur = lm.prefill_with_cache(tparams, tcfg,
                                             torch.from_numpy(tokens), 12)
    assert int(jcur) == tcur == 6
    assert _max_abs(jl, tl.numpy()) <= LM_BAR
    _assert_trees(jcache, tcache)
    tok = jnp.argmax(jl, axis=-1)
    for step in range(6):
        jl, jcache = _decode(jparams, jcfg, tok, jcache,
                             jnp.asarray(tcur + step, jnp.int32))
        tl, tcache = lm.decode_step(tparams, tcfg,
                                    torch.from_numpy(np.array(tok)), tcache,
                                    tcur + step)
        assert _max_abs(jl, tl.numpy()) <= LM_BAR, step
        tok = jnp.argmax(jl, axis=-1)
    _assert_trees(jcache, tcache)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_torch_lm_moe_decodes_from_jax_cache(arch):
    """JAX's KV cache comes across with a template, and the port's decode
    continues it, in place and out of place alike."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    tokens = _tokens(2, 6, seed=3)
    jl, jcache, jcur = _prefill(jparams, jcfg, jnp.asarray(tokens), 12)
    cache = checkpoint.params_from_numpy(
        jax.tree.map(np.asarray, jcache), device="cpu",
        template=lm.init_cache(tcfg, 2, 12, device="cpu"))
    tok = jnp.argmax(jl, axis=-1)
    for step in range(3):
        cur = int(jcur) + step
        jl, jcache = _decode(jparams, jcfg, tok, jcache,
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
    _assert_trees(jcache, cache)


@pytest.mark.parametrize("arch,total,active", [
    ("granite-moe-3b-a800m", 3_425_404_416, 1_009_485_312),
    ("llama4-scout-17b-a16e", 102_235_345_920, 11_638_379_520)])
def test_torch_lm_moe_param_counts_match_jax(arch, total, active):
    """JAX's total and active counts at full width (on the meta device:
    llama4-scout would be 408.9 GB of f32) and reduced."""
    for tcfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                       _model(arch)[1::-1]):
        assert lm.param_counts(tcfg) == jax_lm.param_counts(jcfg)
    assert lm.param_counts(get_config(arch)) == {"total": total,
                                                 "active": active}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_torch_lm_moe_greedy_generate(arch):
    """The serving loop: its prefill logits are JAX's; every token is the
    argmax of the step fed the one before, run out of place from a fresh
    prefill; graphs keyed by (batch, max_len)."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    prompt = _tokens(2, 6, seed=6)
    res = greedy_generate(tparams, tcfg, torch.from_numpy(prompt), 6)
    jl, _, _ = _prefill(jparams, jcfg, jnp.asarray(prompt), 12)
    assert _max_abs(jl, res.prefill_logits.numpy()) <= LM_BAR
    assert tuple(res.tokens.shape) == (2, 6)
    assert torch.equal(res.tokens[:, 0], res.prefill_logits.argmax(-1))
    _, cache, cur = lm.prefill_with_cache(tparams, tcfg,
                                          torch.from_numpy(prompt), 12)
    for i in range(6):
        logits, cache = lm.decode_step(tparams, tcfg, res.tokens[:, i],
                                       cache, cur + i)
        if i < 5:
            assert torch.equal(res.tokens[:, i + 1], logits.argmax(-1))
    assert torch.equal(logits, res.logits)
    assert lm.has_kv_cache(tcfg)
    assert GraphDecoder({}, tcfg).key(2, 12) == (2, 12)
