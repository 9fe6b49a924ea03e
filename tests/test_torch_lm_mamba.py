"""The port's Mamba-2 mixer and zamba2 (Mamba-2 layers with the shared
attention + MLP block) against the JAX package, on the CPU.

The mixer on JAX-initialised params: the sequence forward with and
without its state handoff, for prompts of 1, 2, 5 and 17 tokens (those
shorter than the conv's 3-token tail hand over part of the zero pad), and
decode continued from JAX's state. Then ``reduce_config(zamba2-2.7b)``
(two Mamba-2 layers, each followed by the shared block, d_model 128,
window 8, f32) with params made by JAX's ``lm.init`` and carried across by
``params_from_numpy``: forward and loss, the cached prefill and its
decode, decode continued from JAX's own cache, the shared rings past
their window, param counts and the serving loop. The bar is the LM bar of
ROADMAP queue 1 item 8: max abs difference of logits (and of every
decode-state leaf) <= 1e-4. The JAX functions are jitted (``cfg``
static) so each shape compiles once.
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
from repro.models import mamba as jax_mamba
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.tree import flatten_with_paths
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models import lm, mamba
from repro_torch.serve.decode import GraphDecoder, greedy_generate
from repro_torch.train import checkpoint

LM_BAR = 1e-4
ARCH = "zamba2-2.7b"

_forward = jax.jit(jax_lm.forward, static_argnums=(1,))
_loss = jax.jit(jax_lm.loss_fn, static_argnums=(1,))
_prefill = jax.jit(jax_lm.prefill_with_cache, static_argnums=(1, 3))
_decode = jax.jit(jax_lm.decode_step, static_argnums=(1,))
_MAMBA_KW = ("d_state", "head_dim", "expand")
_mamba_train = jax.jit(jax_mamba.mamba2_train,
                       static_argnames=_MAMBA_KW + ("return_state",))
_mamba_decode = jax.jit(jax_mamba.mamba2_decode, static_argnames=_MAMBA_KW)


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _carry(tree):
    return checkpoint.params_from_numpy(jax.tree.map(np.asarray, tree),
                                        device="cpu")


def _assert_trees(jtree, ttree):
    """Same ``/`` paths, shapes, and leaves within the bar."""
    jflat = flatten_with_paths(jax.tree.map(np.asarray, jtree))
    tflat = flatten_with_paths(checkpoint.params_to_numpy(ttree))
    assert sorted(jflat) == sorted(tflat)
    for key in jflat:
        assert jflat[key].shape == tflat[key].shape, key
        assert _max_abs(jflat[key], tflat[key]) <= LM_BAR, key


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,chunk", [(1, 64), (2, 64), (5, 64), (17, 64),
                                       (17, 4)])
def test_torch_mamba2_layer_matches_jax(seq, chunk, monkeypatch):
    """mamba2_train (out; out and MambaState) and 3 mamba2_decode steps
    from JAX's handed-over state, at d_model 32, state 16, head_dim 16 (4
    heads); ``chunk`` 4 splits the 17 tokens' scan over 5 chunks."""
    monkeypatch.setattr(ssd_ref, "SCAN_CHUNK", chunk)
    kw = dict(d_state=16, head_dim=16)
    jp = jax_mamba.init_mamba2(jax.random.key(seq), 32, **kw)
    tp = _carry(jp)
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((2, seq, 32)).astype(np.float32)
    want = _mamba_train(jp, jnp.asarray(x), **kw)
    got = mamba.mamba2_train(tp, torch.from_numpy(x), **kw)
    assert got.dtype == torch.float32
    assert _max_abs(want, got.numpy()) <= LM_BAR
    jout, jstate = _mamba_train(jp, jnp.asarray(x), return_state=True, **kw)
    tout, tstate = mamba.mamba2_train(tp, torch.from_numpy(x),
                                      return_state=True, **kw)
    assert torch.equal(tout, got)
    assert type(tstate) is mamba.MambaState
    assert tuple(tstate.conv.shape) == (2, mamba.CONV_K - 1, 64 + 32)
    assert tuple(tstate.s.shape) == (2, 4, 16, 16)
    if seq < mamba.CONV_K - 1:            # the pad's zeros lead the tail
        assert not tstate.conv[:, :mamba.CONV_K - 1 - seq].any()
    _assert_trees(jstate, tstate)
    for step in range(3):
        xt = rng.standard_normal((2, 1, 32)).astype(np.float32)
        jy, jstate = _mamba_decode(jp, jnp.asarray(xt), jstate, **kw)
        before = [v.clone() for v in tstate]
        ty, tstate_new = mamba.mamba2_decode(tp, torch.from_numpy(xt),
                                             tstate, **kw)
        assert all(torch.equal(a, b) for a, b in zip(before, tstate))
        tstate = tstate_new
        assert _max_abs(jy, ty.numpy()) <= LM_BAR, step
        _assert_trees(jstate, tstate)


def test_torch_mamba2_init_shapes():
    """The port's own init: the reference's shapes, stacked by ``lead``,
    its decay spectrum and constants."""
    gen = torch.Generator().manual_seed(0)
    p = mamba.init_mamba2(gen, 32, d_state=16, head_dim=16, lead=(3,),
                          device="cpu")
    jp = jax_mamba.init_mamba2(jax.random.key(0), 32, d_state=16,
                               head_dim=16)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: (3,) + v.shape for k, v in jp.items()}
    assert _max_abs(p["A_log"][1], jp["A_log"]) <= 1e-6
    assert float(p["dt_bias"].max()) == float(p["dt_bias"].min()) == -2.0
    assert abs(float(p["w_in"].std()) - 32 ** -0.5) < 0.02


# ---------------------------------------------------------------------------
# zamba2 at the reduced size
# ---------------------------------------------------------------------------


_MODEL: dict = {}


def _model():
    """JAX params of the reduced zamba2 and the same params in torch."""
    if not _MODEL:
        jcfg = jax_reduce_config(jax_get_config(ARCH))
        tcfg = reduce_config(get_config(ARCH))
        jparams = jax.jit(jax_lm.init, static_argnums=(1,))(
            jax.random.key(0), jcfg)
        _MODEL.update(cfgs=(jcfg, tcfg), params=(jparams, _carry(jparams)))
    return _MODEL["cfgs"] + _MODEL["params"]


def _tokens(batch, seq, seed):
    return np.random.default_rng(seed).integers(
        0, 512, (batch, seq)).astype(np.int32)


def test_torch_lm_zamba2_forward_and_loss_match_jax():
    jcfg, tcfg, jparams, tparams = _model()
    assert tcfg.block_pattern == ("mamba2",) and tcfg.shared_attn
    assert (tcfg.n_repeats, tcfg.window) == (2, 8)
    tokens = _tokens(2, 12, seed=1)
    jl, _ = _forward(jparams, jcfg, jnp.asarray(tokens))
    tl, taux = lm.forward(tparams, tcfg, torch.from_numpy(tokens))
    assert tuple(tl.shape) == (2, 12, 512) and float(taux) == 0.0
    assert _max_abs(jl, tl.numpy()) <= LM_BAR
    jloss, jparts = _loss(jparams, jcfg, jnp.asarray(tokens))
    tloss, tparts = lm.loss_fn(tparams, tcfg, torch.from_numpy(tokens))
    assert abs(float(jloss) - tloss.item()) <= LM_BAR
    assert float(tparts["aux"]) == 0.0
    got = lm.prefill(tparams, tcfg, torch.from_numpy(tokens))
    assert _max_abs(jl[:, -1], got.numpy()) <= LM_BAR


@pytest.mark.parametrize("seq", [2, 6])
def test_torch_lm_zamba2_cached_prefill_and_decode_match_jax(seq):
    """The prefill's last logits, cur_index and every state leaf (Mamba
    conv tails and SSM states, the shared block's two rings), then 6
    decode steps fed JAX's greedy tokens, on logits and on the states."""
    jcfg, tcfg, jparams, tparams = _model()
    tokens = _tokens(2, seq, seed=2)
    max_len = seq + 6
    jl, jcache, jcur = _prefill(jparams, jcfg, jnp.asarray(tokens), max_len)
    tl, tcache, tcur = lm.prefill_with_cache(
        tparams, tcfg, torch.from_numpy(tokens), max_len)
    assert int(jcur) == tcur == seq
    assert sorted(tcache) == ["pos_0", "shared"]
    assert type(tcache["pos_0"]) is mamba.MambaState
    assert tcache["shared"].k.shape[:3] == (2, 2, min(8, max_len))
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


def test_torch_lm_zamba2_decodes_from_jax_cache(tmp_path):
    """JAX's decode cache (``MambaState`` leaves and the shared rings)
    comes across with a template, through an npz too, and the port's
    decode continues it, in place and out of place alike; the params'
    unstacked ``dense/shared`` leaves survive an npz round trip."""
    jcfg, tcfg, jparams, tparams = _model()
    tokens = _tokens(2, 5, seed=3)
    jl, jcache, jcur = _prefill(jparams, jcfg, jnp.asarray(tokens), 11)
    template = lm.init_cache(tcfg, 2, 11, device="cpu")
    path = tmp_path / "cache.npz"
    checkpoint.save(str(path), jax.tree.map(np.asarray, jcache))
    cache = checkpoint.params_from_numpy(str(path), device="cpu",
                                         template=template)
    assert type(cache["pos_0"]) is mamba.MambaState
    assert cache["pos_0"].s.shape == (2, 2, 4, 64, 64)
    assert cache["shared"].k.shape == (2, 2, 8, 4, 32)
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
    flat = flatten_with_paths(tparams)
    assert flat["dense/shared/attn/wq"].shape == (128, 4, 32)
    assert flat["dense/blocks/pos_0/mixer/w_in"].shape == (2, 128, 2 * 256
                                                           + 2 * 64 + 4)
    checkpoint.save(str(tmp_path / "p.npz"), tparams)
    back = flatten_with_paths(checkpoint.params_from_numpy(
        str(tmp_path / "p.npz"), device="cpu"))
    assert sorted(back) == sorted(flat)
    assert all(torch.equal(back[k], flat[k]) for k in flat)


def test_torch_lm_zamba2_shared_ring_past_window():
    """A 10-token prompt fills each superblock's shared ring of 8 through
    the roll branch; 12 decode steps wrap it again. Against JAX, and
    against one forward over prompt + fed tokens within the reference's
    decode-vs-forward bar (5e-3)."""
    jcfg, tcfg, jparams, tparams = _model()
    seq, new = 10, 12
    tokens = _tokens(2, seq + new, seed=4)
    prompt, fed = tokens[:, :seq], tokens[:, seq:]
    jl, jcache, _ = _prefill(jparams, jcfg, jnp.asarray(prompt), seq + new)
    tl, tcache, cur = lm.prefill_with_cache(tparams, tcfg,
                                            torch.from_numpy(prompt),
                                            seq + new)
    assert tcache["shared"].k.shape[2] == 8                      # the ring
    assert _max_abs(jl, tl.numpy()) <= LM_BAR
    _assert_trees(jcache, tcache)
    outs = [tl]
    for i in range(new):
        jl, jcache = _decode(jparams, jcfg, jnp.asarray(fed[:, i]), jcache,
                             jnp.asarray(cur + i, jnp.int32))
        tl, tcache = lm.decode_step(tparams, tcfg, torch.from_numpy(fed[:, i]),
                                    tcache, cur + i, inplace=True)
        assert _max_abs(jl, tl.numpy()) <= LM_BAR, i
        outs.append(tl)
    _assert_trees(jcache, tcache)
    full, _ = lm.forward(tparams, tcfg, torch.from_numpy(tokens))
    got = torch.stack(outs[:-1], dim=1)
    assert _max_abs(full[:, seq - 1:seq - 1 + new], got) <= 5e-3


def test_torch_lm_zamba2_param_counts_match_jax():
    """JAX's counts at full width (2,422,670,240: 9.69 GB of f32, on the
    meta device) and reduced; no MoE, so active == total."""
    for tcfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)),
                       _model()[1::-1]):
        assert lm.param_counts(tcfg) == jax_lm.param_counts(jcfg)
    assert lm.param_counts(get_config(ARCH)) == {
        "total": 2_422_670_240, "active": 2_422_670_240}


def test_torch_lm_zamba2_greedy_generate():
    """The serving loop: its prefill logits are JAX's; every token is the
    argmax of the step fed the one before, run out of place from a fresh
    prefill, past the shared rings' window."""
    jcfg, tcfg, jparams, tparams = _model()
    prompt = _tokens(3, 7, seed=6)
    res = greedy_generate(tparams, tcfg, torch.from_numpy(prompt), 6)
    jl, _, _ = _prefill(jparams, jcfg, jnp.asarray(prompt), 13)
    assert _max_abs(jl, res.prefill_logits.numpy()) <= LM_BAR
    assert tuple(res.tokens.shape) == (3, 6)
    assert torch.equal(res.tokens[:, 0], res.prefill_logits.argmax(-1))
    _, cache, cur = lm.prefill_with_cache(tparams, tcfg,
                                          torch.from_numpy(prompt), 13)
    for i in range(6):
        logits, cache = lm.decode_step(tparams, tcfg, res.tokens[:, i],
                                       cache, cur + i)
        if i < 5:
            assert torch.equal(res.tokens[:, i + 1], logits.argmax(-1))
    assert torch.equal(logits, res.logits)


def test_torch_lm_zamba2_has_kv_cache_and_graph_key():
    """zamba2's pattern is Mamba-2 alone, but its shared rings hold
    ``min(window, max_len)`` slots: it has a KV cache, and its decode
    graphs are keyed by (batch, max_len)."""
    _, tcfg, _, _ = _model()
    assert lm.has_kv_cache(tcfg) and lm.has_kv_cache(get_config(ARCH))
    assert not lm.has_kv_cache(dataclasses.replace(tcfg, shared_attn=False))
    assert GraphDecoder({}, tcfg).key(3, 40) == (3, 40)
    for max_len, ring in ((40, 8), (5, 5)):
        cache = lm.init_cache(tcfg, 3, max_len, device="cpu")
        assert cache["shared"].k.shape == (2, 3, ring, 4, 32)
        assert cache["pos_0"].conv.shape == (2, 3, 3, 256 + 128)
