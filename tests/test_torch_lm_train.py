"""The port's LM training (``--task lm``) against the JAX package, on the
CPU.

The reference is the body of ``repro.launch.train.run_lm``'s step without
its mesh: ``jax.value_and_grad`` of ``lm.loss_fn``, ``build_optimizer(hp,
warmup_steps=10)`` updated with ``counts={"tokens": token_counts(...)}``
and ``apply_updates`` (on jax 0.9.0 the CLI itself stops at the token
gather under ``make_host_mesh``, ROADMAP queue 3). Params are made by
JAX's ``lm.init`` at the reduced size (``reduce_config``: f32, 2 or 4
layers, d_model 128, vocab 512) and carried across as numpy; tokens come
from ``make_lm_tokens`` and prefixes from ``default_rng``, as run_lm draws
them. The bar is the LM bar, max abs difference <= 1e-4, for the loss
and every param leaf after 3 steps of the port's
``make_lm_train_step`` (the fused CowClip update on the token table, the
dense tree a leaf at a time), and 1e-4 of each gradient leaf's own
largest value (rwkv6's scan backend its own bar, for the cause given at
RWKV6_SCAN_GRAD_BAR); the wkv6 kernel's gradient (the plain
chunked version's, recomputed) against ``jax.grad`` through JAX's chunked
twin at 1e-4 of the largest gradient; ``token_counts`` exactly.
"""

import dataclasses
import functools
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.core.builders import build_optimizer as jax_build_optimizer
from repro.core.optim import apply_updates as jax_apply_updates
from repro.core.scaling import scale_hyperparams as jax_scale_hyperparams
from repro.models import embedding as jax_embedding
from repro.models import lm as jax_lm
from repro.models import rwkv as jax_rwkv
from repro.train import checkpoint as jax_checkpoint
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.builders import build_optimizer, dense_tower_tx
from repro_torch.core.optim import ScaleByAdamState
from repro_torch.core.scaling import scale_hyperparams
from repro_torch.core.tree import flatten_with_paths, tree_map
from repro_torch.data import make_lm_tokens
from repro_torch.kernels.wkv6 import (chunked_wkv6_reference, clipped_chunks,
                                      wkv6)
from repro_torch.models import embedding, lm, mamba, rwkv
from repro_torch.train import checkpoint, loop

LM_BAR = 1e-4
REPO = Path(__file__).resolve().parents[1]
# run_lm's hyperparameters (base batch 1024) at batch * seq = 1024
HP_KW = dict(base_lr=2e-2, base_l2=1e-5, base_batch=1024, batch_size=1024,
             base_dense_lr=4e-2)
BATCH, SEQ, STEPS = 4, 32, 3
# a gradient leaf's max abs difference over its own largest |value|.
# Observed <= 6.1e-6 for every leaf of every case but rwkv6-7b's, and
# <= 7.2e-5 for its chunked backend against JAX's.
GRAD_BAR = 1e-4
# rwkv6-7b's scan backend against JAX's scan: 1.92e-4 (wr), u 1.87e-4, wk
# 1.79e-4, mix_r 1.58e-4, all in the time mix; JAX's own scan and chunked
# backends are 6.1e-5 apart. The cause is the per-head norm of the wkv
# output, eps 1e-5: it divides positions whose output is tiny by up to
# 1/sqrt(eps) = 316, so f32 rounding set by the largest outputs comes back
# magnified in the gradients of the r/k path. With eps 0.1 on both sides
# the gap is under CAUSE_BAR (test_torch_rwkv6_grad_gap_is_the_head_norm).
RWKV6_SCAN_GRAD_BAR = 3e-4
CAUSE_BAR = 2e-5
FUSED_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_torch_train_fused.py


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _flat_to_tree(tree):
    """A torch tree as a tree of numpy arrays (for JAX)."""
    return tree_map(lambda t: t.detach().numpy(), tree)


def _carry(tree):
    return checkpoint.params_from_numpy(jax.tree.map(np.asarray, tree),
                                        device="cpu")


def _flat_numpy(tree):
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in flatten_with_paths(tree).items()}


def _assert_trees_close(want, got, bar, what):
    want, got = _flat_numpy(want), _flat_numpy(got)
    assert sorted(want) == sorted(got), what
    worst = {k: _max_abs(want[k], got[k]) for k in want}
    key = max(worst, key=worst.get)
    assert worst[key] <= bar, f"{what}: {key} differs by {worst[key]:.3e}"


# ---------------------------------------------------------------------------
# token_counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,seq,vocab", [(2, 7, 5), (4, 32, 512),
                                             (3, 64, 4096), (1, 1, 256)])
def test_torch_token_counts_match_jax(batch, seq, vocab):
    """Exactly the reference's ``segment_sum`` of ones, f32 ``[V]``, with
    a vocab's last id and the Zipf head present."""
    tokens = make_lm_tokens(batch * seq, vocab, seed=vocab).reshape(
        batch, seq)
    tokens[0, 0] = vocab - 1
    want = np.asarray(jax_embedding.token_counts(jnp.asarray(tokens), vocab))
    got = embedding.token_counts(torch.from_numpy(tokens), vocab)
    assert got.dtype == torch.float32 and tuple(got.shape) == (vocab,)
    assert got.is_contiguous()
    assert np.array_equal(want, got.numpy())


# ---------------------------------------------------------------------------
# wkv6 under autograd
# ---------------------------------------------------------------------------


def _wkv_streams(seq, seed, b=2, n_heads=2, n=16):
    """r, k, v, wlog [B, S, D], u [D] and y's cotangent (f32). wlog ~
    N(-0.6, 1) (the model's decays), and 2.5 in the last channel of each
    head, whose chunks decay past the clip (a total log decay of ~-195 a
    chunk); the decay is the model's ``w = exp(-exp(wlog))``."""
    rng = np.random.default_rng(seed)
    d = n_heads * n
    r, k, v = (rng.standard_normal((b, seq, d)).astype(np.float32)
               for _ in range(3))
    wlog = (rng.standard_normal((b, seq, d)) - 0.6).astype(np.float32)
    wlog[..., n - 1::n] = 2.5
    u = (0.5 * rng.standard_normal(d)).astype(np.float32)
    cot = rng.standard_normal((b, seq, n_heads, n)).astype(np.float32)
    return (r, k, v, wlog, u), cot, n_heads


def _jax_wkv_grads(arrays, cot, n_heads, chunk=16):
    """``jax.grad`` of ``sum(y * cot)`` through JAX's chunked twin,
    padding a ragged length as the port does (r = k = v = 0, w = 1)."""
    r, k, v, wlog, u = (jnp.asarray(a) for a in arrays)
    seq = r.shape[1]
    pad = -seq % chunk

    def loss(r, k, v, wlog, u):
        def padded(t, fill):
            return jnp.pad(t, ((0, 0), (0, pad), (0, 0)),
                           constant_values=fill)
        w = jnp.exp(-jnp.exp(wlog))
        y = jax_rwkv._wkv_chunked({"u": u}, n_heads, padded(r, 0.0),
                                  padded(k, 0.0), padded(v, 0.0),
                                  padded(w, 1.0), chunk=chunk)
        return jnp.sum(y[:, :seq] * cot)

    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(r, k, v, wlog, u)


def _heads(t, n_heads, chunk=16):
    """[B, S, D] -> [B * H, S padded to whole chunks (with 1), N]."""
    b, _, d = t.shape
    t = torch.nn.functional.pad(t, (0, 0, 0, -t.shape[1] % chunk), value=1.0)
    return (t.reshape(b, -1, n_heads, d // n_heads).transpose(1, 2)
            .reshape(b * n_heads, -1, d // n_heads).contiguous())


@pytest.mark.parametrize("seq", [64, 50])
def test_torch_wkv6_grads_match_jax(seq):
    """Gradients of r, k, v, w (through the model's ``w = exp(-exp(wlog))``)
    and u through the model's chunked backend (the wkv6 Function; S = 50
    is padded to 64) against ``jax.grad`` through JAX's chunked twin: each
    within 1e-4 of its largest value. Some chunk-channels break the clip,
    where both pass zero gradient."""
    arrays, cot, n_heads = _wkv_streams(seq, seed=seq)
    want = _jax_wkv_grads(arrays, cot, n_heads)
    r, k, v, wlog, u = (torch.from_numpy(a).requires_grad_() for a in arrays)
    w = torch.exp(-torch.exp(wlog))
    assert clipped_chunks(_heads(w.detach(), n_heads)) > 0
    y, _ = rwkv._wkv_chunked({"u": u}, n_heads, r, k, v, w)
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                              (r, k, v, wlog, u))
    for name, a, b in zip("rkvwu", want, got):
        scale = float(np.max(np.abs(np.asarray(a))))
        err = _max_abs(a, b.numpy())
        assert err <= LM_BAR * scale, f"d{name}: {err:.3e} (max {scale})"


@pytest.mark.parametrize("need", ["all", "y_only", "state_only"])
def test_torch_wkv6_function_grads_are_plain_autograd(need):
    """The wrapper's gradient is autograd's through the plain chunked
    version, bit for bit on the CPU, for y's and the final state's
    cotangents together or alone; the CPU counts no kernel launch."""
    arrays, _, _ = _wkv_streams(32, seed=7, b=1)
    rng = np.random.default_rng(8)
    bh, n = 2, 16
    r, k, v, wlog = (_heads(torch.from_numpy(a), bh) for a in arrays[:4])
    w = torch.exp(-torch.exp(wlog))
    u = torch.from_numpy(arrays[4]).reshape(bh, n)
    gy = torch.from_numpy(rng.standard_normal((bh, 32, n)).astype(np.float32))
    gs = torch.from_numpy(rng.standard_normal((bh, n, n)).astype(np.float32))
    grads = {}
    for name, fn in (("wrapper", wkv6), ("plain", chunked_wkv6_reference)):
        ins = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
        before = wkv6.launches
        y, s = fn(*ins, chunk=16)
        assert wkv6.launches == before
        loss = ((y * gy).sum() if need != "state_only" else 0) \
            + ((s * gs).sum() if need != "y_only" else 0)
        grads[name] = torch.autograd.grad(loss, ins, allow_unused=True)
    for a, b in zip(grads["wrapper"], grads["plain"]):
        assert (a is None and b is None) or torch.equal(a, b)


# ---------------------------------------------------------------------------
# the Mamba-2 scan's two branches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq", [1, 5, 64, 70])
def test_torch_mamba_scan_grad_branch_equals_serving_branch(seq):
    """The scan under autograd (each token's state a new tensor) gives
    the serving branch's bits (the chunk buffer written with ``out=``):
    y and the final state, inside a chunk and across chunks of 64."""
    rng = np.random.default_rng(seq)
    b, h, p, n = 2, 3, 8, 16

    def arr(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape))
                                .astype(np.float32))

    xs, bmat, cmat = arr(b, seq, h, p), arr(b, seq, n), arr(b, seq, n)
    dt = torch.nn.functional.softplus(arr(b, seq, h) - 2.0)
    a_log, d_skip = arr(h, scale=0.5), arr(h)
    with torch.no_grad():
        want = mamba._ssm_scan(xs, bmat, cmat, dt, a_log, d_skip)
    ins = [t.clone().requires_grad_() for t in (xs, bmat, cmat, dt, a_log,
                                                d_skip)]
    got = mamba._ssm_scan(*ins)
    assert got[0].requires_grad
    for a, g in zip(want, got):
        assert torch.equal(a, g.detach())
    grads = torch.autograd.grad(got[0].sum() + got[1].sum(), ins)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# ---------------------------------------------------------------------------
# the dense update, a leaf at a time
# ---------------------------------------------------------------------------


def _dense_tree(rng, scale=1.0):
    def arr(*shape):
        return torch.from_numpy((scale * rng.standard_normal(shape))
                                .astype(np.float32))

    return {"blocks": {"pos_0": {"w": arr(3, 5, 7), "b": arr(3, 7)},
                       "pos_1": {"norm": arr(3, 5)}},
            "head": arr(5, 11), "final_norm": {"scale": arr(5)}}


@pytest.mark.parametrize("dense_l2", [0.0, 1e-3])
def test_torch_update_leafwise_bitwise_tree_form(dense_l2):
    """``loop.update_leafwise`` over ``dense_tower_tx`` (L2 or none, Adam,
    the 10-step warm-up) equals the tree form, one ``tx.update`` over the
    whole tree then ``write_back``, bit for bit, params and state, over 4
    steps; the counters advance once a step."""
    hp = dataclasses.replace(scale_hyperparams("cowclip", **HP_KW),
                             dense_l2=dense_l2)
    tx = dense_tower_tx(hp, warmup_steps=10)
    rng = np.random.default_rng(3)
    params = {"leaf": _dense_tree(rng), "tree": None}
    params["tree"] = tree_map(torch.clone, params["leaf"])
    state = {k: tx.init(p) for k, p in params.items()}
    for _ in range(4):
        grads = _dense_tree(rng, scale=0.1)
        loop.update_leafwise(tx, grads, state["leaf"], params["leaf"])
        updates, new = tx.update(grads, state["tree"], params["tree"])
        loop.write_back(params["tree"],
                        loop.apply_updates(params["tree"], updates))
        loop.write_back(state["tree"], new)
    for key in ("leaf", "tree"):
        params[key] = _flat_numpy(params[key])
        state[key] = _flat_numpy(state[key])
    for a, b in ((params["leaf"], params["tree"]),
                 (state["leaf"], state["tree"])):
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) for k in a)
    counts = [v for k, v in state["leaf"].items() if k.endswith("count")]
    assert counts and all(int(c) == 4 for c in counts)


# ---------------------------------------------------------------------------
# the step of run_lm, per arch
# ---------------------------------------------------------------------------


LM_CASES = [
    pytest.param("gemma3-12b", {}, GRAD_BAR, id="gemma3-12b"),
    pytest.param("stablelm-3b", {}, GRAD_BAR, id="stablelm-3b"),
    pytest.param("rwkv6-7b", {"wkv_backend": "scan"}, RWKV6_SCAN_GRAD_BAR,
                 id="rwkv6-7b-scan"),
    pytest.param("rwkv6-7b", {"wkv_backend": "chunked"}, GRAD_BAR,
                 id="rwkv6-7b-chunked"),
    pytest.param("zamba2-2.7b", {}, GRAD_BAR, id="zamba2-2.7b"),
    pytest.param("granite-moe-3b-a800m", {}, GRAD_BAR,
                 id="granite-moe-3b-a800m"),
    pytest.param("musicgen-large", {}, GRAD_BAR, id="musicgen-large"),
    pytest.param("internvl2-26b", {}, GRAD_BAR, id="internvl2-26b"),
]


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_reduce_config(jax_get_config(arch)),
                                **kw),
            dataclasses.replace(reduce_config(get_config(arch)), **kw))


def _batches(cfg, seed, steps=STEPS):
    """run_lm's batches: consecutive ``[BATCH, SEQ]`` slices of one Zipf
    stream, and for a frontend a prefix a step from ``default_rng(seed)``
    (f64 normals, cast to the compute dtype, f32 here)."""
    stream = make_lm_tokens(steps * BATCH * SEQ, cfg.vocab_size, seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(steps):
        tokens = stream[i * BATCH * SEQ:(i + 1) * BATCH * SEQ].reshape(
            BATCH, SEQ)
        prefix = None
        if cfg.frontend:
            prefix = rng.normal(scale=0.1, size=(
                BATCH, cfg.n_prefix, cfg.d_model)).astype(np.float32)
        out.append((tokens, prefix))
    return out


class _JaxStep:
    """run_lm's step body without the mesh, in two halves:
    ``loss_and_grads(params, tokens, prefix)`` (``jax.value_and_grad`` of
    ``lm.loss_fn``) and ``update(grads, opt, params, tokens)``
    (``build_optimizer(hp, warmup_steps=10)`` with ``counts={"tokens":
    token_counts(tokens)}``, then ``apply_updates``), each jitted."""

    def __init__(self, jcfg):
        tx = jax_build_optimizer(jax_scale_hyperparams("cowclip", **HP_KW),
                                 warmup_steps=10)
        self.init = tx.init

        @jax.jit
        def loss_and_grads(p, tokens, prefix):
            return jax.value_and_grad(
                lambda pp: jax_lm.loss_fn(pp, jcfg, tokens, prefix)[0])(p)

        @jax.jit
        def update(g, o, p, tokens):
            counts = {"tokens": jax_embedding.token_counts(
                tokens, jcfg.padded_vocab)}
            u, o = tx.update(g, o, p, counts=counts)
            return jax_apply_updates(p, u), o

        self.loss_and_grads, self.update = loss_and_grads, update


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch_batch(tokens, prefix):
    return {"tokens": torch.from_numpy(tokens),
            "prefix": None if prefix is None else torch.from_numpy(prefix)}


def _grad_errors(want, got):
    """Each leaf's max abs difference over its own largest |value| in the
    reference (0 where both are all zero)."""
    want, got = _flat_numpy(want), _flat_numpy(got)
    assert sorted(want) == sorted(got)
    out = {}
    for k in want:
        err, scale = _max_abs(want[k], got[k]), float(np.max(np.abs(want[k])))
        out[k] = err / scale if scale else (0.0 if not err else np.inf)
    return out


@pytest.mark.parametrize("arch,kw,grad_bar", LM_CASES)
def test_torch_lm_train_step_matches_jax(arch, kw, grad_bar):
    """Three steps of ``make_lm_train_step`` (the fused CowClip update on
    the token table, the dense tree a leaf at a time) held to run_lm's
    step body along the port's own trajectory. At each step, from the
    port's params: the loss within 1e-4 of ``jax.value_and_grad``'s, and
    every gradient leaf (``loss_fn`` under autograd: the token table's
    from the embedding backward, wkv6's and the Mamba-2 scan's backward,
    the MoE's aux) within ``grad_bar`` of its own largest value (GRAD_BAR,
    1e-4; rwkv6's scan RWKV6_SCAN_GRAD_BAR); and JAX's update
    of those same gradients (the port's, which the step computes the same
    way) tracked beside it: every param leaf within 1e-4 of it after the
    3 steps. (Adam's ``m / (sqrt(v) + eps)`` turns the f32 noise of a
    gradient near eps into a step-sized difference, so the two halves are
    held apart: from its own gradients JAX parts from the port, as its
    scan and chunked rwkv6 backends part from each other, by up to 3e-2
    in a param after 3 steps.)"""
    jcfg, tcfg = _cfgs(arch, **kw)
    batches = _batches(tcfg, seed=len(arch))
    ref = _JaxStep(jcfg)
    init = jax_lm.init(jax.random.key(0), jcfg)
    params, jparams, jopt = _carry(init), init, ref.init(init)

    hp = scale_hyperparams("cowclip", **HP_KW)
    step, init_state = loop.make_lm_train_step(tcfg, hp, warmup_steps=10)
    state = init_state(params)
    for tokens, prefix in batches:
        batch = _torch_batch(tokens, prefix)
        jprefix = None if prefix is None else jnp.asarray(prefix)
        want_loss, want_grads = ref.loss_and_grads(
            _jnp(_flat_to_tree(params)), jnp.asarray(tokens), jprefix)
        loss, grads = loop._grads(params, lambda view: lm.loss_fn(
            view, tcfg, batch["tokens"], batch["prefix"])[0])
        assert abs(float(loss) - float(want_loss)) <= LM_BAR
        errs = _grad_errors(want_grads, grads)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= grad_bar, f"{arch} d{worst}: {errs[worst]:.3e}"
        jparams, jopt = ref.update(_jnp(_flat_to_tree(grads)), jopt,
                                   jparams, jnp.asarray(tokens))
        params, state, aux = step(params, state, batch)
        assert torch.equal(aux["loss"], loss)
    assert int(state["step"]) == STEPS
    _assert_trees_close(jparams, params, LM_BAR, f"{arch} params")


@pytest.mark.parametrize("backend", ["scan", "chunked"])
def test_torch_rwkv6_grad_gap_is_the_head_norm(backend, monkeypatch):
    """Why rwkv6's scan gradients get their own bar: with the per-head
    norm's eps raised from 1e-5 to 0.1 in both the port and JAX (so no
    position's output is divided by more than ~3), every gradient leaf of
    the reduced rwkv6-7b at the initial params is within CAUSE_BAR of its
    own largest value of JAX's, for both backends."""
    monkeypatch.setattr(rwkv, "_head_norm", functools.partial(
        rwkv._head_norm, eps=0.1))
    monkeypatch.setattr(jax_rwkv, "_head_norm", functools.partial(
        jax_rwkv._head_norm, eps=0.1))
    jcfg, tcfg = _cfgs("rwkv6-7b", wkv_backend=backend)
    tokens = _batches(tcfg, seed=len("rwkv6-7b"))[0][0]
    params = _carry(jax_lm.init(jax.random.key(0), jcfg))
    want_loss, want = _JaxStep(jcfg).loss_and_grads(
        _jnp(_flat_to_tree(params)), jnp.asarray(tokens), None)
    loss, got = loop._grads(params, lambda view: lm.loss_fn(
        view, tcfg, torch.from_numpy(tokens))[0])
    assert abs(float(loss) - float(want_loss)) <= LM_BAR
    errs = _grad_errors(want, got)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= CAUSE_BAR, f"d{worst}: {errs[worst]:.3e}"

def _as_substrate_state(tx, params, state):
    """The fused step's state as the substrate's: the token table's
    moments and step in the embed group's Adam, the dense tree's state as
    it is (copies)."""
    sub = tx.init(params)
    (_, adam), dense = sub
    loop.write_back(adam, ScaleByAdamState(
        count=state["step"], mu=state["m"], nu=state["v"]))
    loop.write_back(dense, state["dense"])
    return sub


@pytest.mark.parametrize("arch,kw", [
    pytest.param("rwkv6-7b", {"wkv_backend": "chunked"},
                 id="rwkv6-7b-chunked"),
    pytest.param("granite-moe-3b-a800m", {}, id="granite-moe-3b-a800m"),
])
def test_torch_lm_fused_step_matches_substrate(arch, kw):
    """The CLI's form (the fused CowClip update, the dense tree a leaf at
    a time) against the substrate form (``build_optimizer(hp,
    warmup_steps=10)`` as ``tx`` over the whole tree), one step at a time
    from the same params and state over 3 steps: the loss bitwise (the
    same forward), every param leaf, the token table's moments and the
    dense state within ``tests/test_torch_train_fused.py``'s TOL. (Run
    apart, the two part after a step or two where a gradient is near
    Adam's eps, as the reference's placements do: ROADMAP queue 3.)"""
    _, tcfg = _cfgs(arch, **kw)
    hp = scale_hyperparams("cowclip", **HP_KW)
    tx = build_optimizer(hp, warmup_steps=10)
    fused, init_state = loop.make_lm_train_step(tcfg, hp)
    substrate, _ = loop.make_lm_train_step(tcfg, hp, tx=tx)
    params = lm.init(tcfg, seed=1, device="cpu")
    state = init_state(params)
    for tokens, prefix in _batches(tcfg, seed=5):
        batch = _torch_batch(tokens, prefix)
        sub_params = tree_map(torch.clone, params)
        sub_params, sub_state, sub_aux = substrate(
            sub_params, _as_substrate_state(tx, sub_params, state), batch)
        params, state, aux = fused(params, state, batch)
        assert torch.equal(aux["loss"], sub_aux["loss"])
        (_, adam), dense = sub_state
        for got, want in ((params, sub_params), (state["m"], adam.mu),
                          (state["v"], adam.nu), (state["dense"], dense)):
            want = flatten_with_paths(want)
            for k, v in flatten_with_paths(got).items():
                torch.testing.assert_close(v, want[k], **FUSED_TOL, msg=k)
    assert int(state["step"]) == STEPS


def test_torch_cli_trains_lm_and_checkpoints_for_jax(tmp_path):
    """``--task lm --device cpu --arch gemma3-12b --reduced --batch 16
    --seq 64 --steps 5`` exits 0 with the loss falling (run_lm's closing
    check), and its ``--checkpoint`` npz restores through JAX's
    ``checkpoint.restore`` into JAX's ``lm.init`` tree: the same keys and
    shapes, and the values the port wrote."""
    ckpt = tmp_path / "lm.npz"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--task", "lm",
         "--device", "cpu", "--arch", "gemma3-12b", "--reduced", "--batch",
         "16", "--seq", "64", "--steps", "5", "--checkpoint", str(ckpt)],
        env={**__import__("os").environ, "PYTHONPATH": str(REPO / "src")},
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    done = re.search(r"\[train-lm\] 5 steps in [0-9.]+s; loss ([0-9.]+) -> "
                     r"([0-9.]+)", out.stdout)
    assert done and float(done[2]) < float(done[1]), out.stdout
    jcfg = jax_reduce_config(jax_get_config("gemma3-12b"))
    template = jax_lm.init(jax.random.key(1), jcfg)
    restored = jax_checkpoint.restore(str(ckpt), template)
    want = {k: np.asarray(v) for k, v in np.load(ckpt).items()}
    got = _flat_numpy(jax.tree.map(np.asarray, restored))
    shapes = {k: v.shape for k, v in
              _flat_numpy(jax.tree.map(np.asarray, template)).items()}
    assert sorted(got) == sorted(want) == sorted(shapes)
    for k in want:
        assert got[k].shape == shapes[k] and np.array_equal(got[k], want[k])
