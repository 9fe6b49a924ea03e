"""Activation checkpointing in the port's LM (``cfg.remat``,
``remat_policy`` "full" and "dots") against the JAX package's, on the CPU.

For each of the eight arch cases of ``test_torch_lm_train.py`` at its
reduced size (params made by JAX's ``lm.init`` and carried across), with
``remat=True``: the loss within 1e-4 and every gradient leaf within
``GRAD_BAR`` of its own largest value (rwkv6's scan backend
``RWKV6_SCAN_GRAD_BAR``) of ``jax.value_and_grad(lm.loss_fn)`` under the
same ``remat`` and ``remat_policy`` (JAX's remat is not bitwise its
no-remat: the gradient sums differ in the last digits), and the port's
gradients with remat bitwise its gradients without. The "dots" policy's
cases are ``test_torch_remat_dots.py``'s; remat off is
``test_torch_lm_train.py``'s. Here also: "dots" keeps exactly the
``aten.mm`` / ``aten.addmm`` outputs (its step runs the products of no
remat, and recomputes every ``aten.bmm`` that "full" does), and the
FLOPs: with non-reentrant checkpoint's early stop off, full remat's are
no remat's plus one superblock forward a repeat; with it on (the
default), they are fewer, and "dots" lies strictly between no remat and
full.
"""

import dataclasses
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import checkpoint as ckpt
from torch.utils.flop_counter import FlopCounterMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import lm as jax_lm
import jax
from repro_torch.core.tree import tree_leaves
from repro_torch.models import lm
from repro_torch.train import loop
from test_torch_lm_train import (LM_BAR, LM_CASES, _JaxStep, _batches,
                                 _carry, _cfgs, _flat_to_tree, _grad_errors,
                                 _jnp)


def port_grads(params, cfg, tokens, prefix):
    return loop._grads(params, lambda view: lm.loss_fn(
        view, cfg, torch.from_numpy(tokens),
        None if prefix is None else torch.from_numpy(prefix))[0])


def check_remat_case(arch, kw, grad_bar, policy):
    """One case: the port's remat loss and gradients against JAX's remat
    step, and bitwise against its own without remat."""
    jcfg, tcfg = _cfgs(arch, remat=True, remat_policy=policy, **kw)
    tokens, prefix = _batches(tcfg, seed=len(arch), steps=1)[0]
    init = jax_lm.init(jax.random.key(0), jcfg)
    params = _carry(init)
    want_loss, want = _JaxStep(jcfg).loss_and_grads(
        _jnp(_flat_to_tree(params)), jnp.asarray(tokens),
        None if prefix is None else jnp.asarray(prefix))
    loss, grads = port_grads(params, tcfg, tokens, prefix)
    assert abs(float(loss) - float(want_loss)) <= LM_BAR
    errs = _grad_errors(want, grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= grad_bar, f"{arch} d{worst}: {errs[worst]:.3e}"
    plain_loss, plain = port_grads(params, dataclasses.replace(
        tcfg, remat=False), tokens, prefix)
    assert torch.equal(loss, plain_loss)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                                 tree_leaves(plain)))


@pytest.mark.parametrize("arch,kw,grad_bar", LM_CASES)
def test_torch_remat_full_matches_jax(arch, kw, grad_bar):
    check_remat_case(arch, kw, grad_bar, "full")


class _ProductCount(TorchDispatchMode):
    """How many times each product op runs."""

    def __init__(self):
        super().__init__()
        self.counts = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                    torch.ops.aten.bmm.default):
            self.counts[func.__name__.split(".")[0]] += 1
        return func(*args, **(kwargs or {}))


def _step_counts(params, cfg, tokens, prefix):
    with _ProductCount() as pc, FlopCounterMode(display=False) as fc:
        port_grads(params, cfg, tokens, prefix)
    return pc.counts, fc.get_total_flops()


def _superblock_flops(params, cfg, tokens, prefix) -> int:
    """One forward of every superblock, as ``lm.forward`` runs them."""
    x = lm._embed(params, cfg, torch.from_numpy(tokens),
                  None if prefix is None else torch.from_numpy(prefix))
    aux = torch.zeros(())
    shared = params["dense"].get("shared")
    total = 0
    with torch.no_grad():
        for rep in range(cfg.n_repeats):
            with FlopCounterMode(display=False) as fc:
                x, aux = lm._superblock(lm._repeat(params["dense"]["blocks"],
                                                   rep), shared, cfg, x, aux)
            total += fc.get_total_flops()
    return total


@pytest.mark.parametrize("arch", ["stablelm-3b", "granite-moe-3b-a800m"])
def test_torch_remat_dots_saves_exactly_the_mm_outputs(arch):
    """"dots" runs as many ``mm`` / ``addmm`` as no remat (their outputs
    are kept, none recomputed) and as many ``bmm`` as "full" (every one
    recomputed); "full" runs more of both than no remat. FLOPs: no remat
    < dots < full; with checkpoint's early stop off, full == no remat +
    one superblock forward a repeat. stablelm-3b's attention and
    granite-moe's expert einsums are the ``aten.bmm`` kinds."""
    _, cfg = _cfgs(arch)
    params = lm.init(cfg, seed=1, device="cpu")
    tokens, prefix = _batches(cfg, seed=len(arch), steps=1)[0]
    off, off_f = _step_counts(params, cfg, tokens, prefix)
    full_cfg = dataclasses.replace(cfg, remat=True, remat_policy="full")
    full, full_f = _step_counts(params, full_cfg, tokens, prefix)
    dots, dots_f = _step_counts(params, dataclasses.replace(
        cfg, remat=True, remat_policy="dots"), tokens, prefix)
    assert dots["mm"] + dots["addmm"] == off["mm"] + off["addmm"]
    assert dots["bmm"] == full["bmm"]
    assert full["mm"] + full["addmm"] > off["mm"] + off["addmm"]
    assert off_f < dots_f < full_f
    with ckpt.set_checkpoint_early_stop(False):
        _, whole = _step_counts(params, full_cfg, tokens, prefix)
    assert whole == off_f + _superblock_flops(params, cfg, tokens, prefix)
    assert full_f <= whole


def test_torch_remat_moe_aux_reaches_the_loss():
    """The MoE aux carried through the checkpointed superblocks reaches
    the loss unchanged (granite-moe, both policies)."""
    _, cfg = _cfgs("granite-moe-3b-a800m")
    params = lm.init(cfg, seed=2, device="cpu")
    tokens = torch.from_numpy(_batches(cfg, seed=3, steps=1)[0][0])
    _, want = lm.loss_fn(params, cfg, tokens)
    assert float(want["aux"]) > 0
    for policy in ("full", "dots"):
        rcfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        _, got = lm.loss_fn(params, rcfg, tokens)
        assert torch.equal(got["aux"], want["aux"])
        assert torch.equal(got["ce"], want["ce"])


def test_torch_remat_unknown_policy_raises():
    _, cfg = _cfgs("stablelm-3b", remat=True, remat_policy="everything")
    params = lm.init(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        lm.forward(params, cfg, torch.zeros((1, 4), dtype=torch.int64))
