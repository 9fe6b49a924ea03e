"""The port's dry-run FLOPs against the JAX step's, on the CPU.

For each arch of the mini dry-run (``test_torch_dryrun.MINI``: d_model
256, 8 heads, vocab 512, ``remat=True``, batch 8 x 64), the train step
traced on one rank (``mesh=False``: unsharded, so its count is the
whole step's) counts, in its forward and backward, within 1% of the
``dot_general`` FLOPs of ``jax.make_jaxpr(jax.value_and_grad(loss))`` of
JAX's step at the same size on one device; the walk enters every
sub-jaxpr (remat, pjit, custom rules) and multiplies a scan's body by its
length. JAX's dry-run itself does not run on jax 0.9.0 (ROADMAP queue 3).
"""

import math

import jax
import jax.numpy as jnp
import pytest

from repro.models import lm as jax_lm
from repro_torch.launch import dryrun
from test_torch_dryrun import MINI, TRAIN, mini_cfgs

FLOP_BAR = 0.01


def dot_general_flops(jaxpr, scale: int = 1) -> int:
    """2 * output size * contracted size of every ``dot_general``, a scan
    body's times its length."""
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (contract, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval
            total += scale * 2 * math.prod(eqn.outvars[0].aval.shape) \
                * math.prod(lhs.shape[i] for i in contract)
        inner = scale * (eqn.params.get("length", 1)
                         if eqn.primitive.name == "scan" else 1)
        for value in eqn.params.values():
            for sub in (value if isinstance(value, (tuple, list))
                        else (value,)):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    total += dot_general_flops(sub, inner)
    return total


@pytest.mark.parametrize("arch,kv", MINI, ids=[a for a, _ in MINI])
def test_torch_dryrun_train_flops_match_jax_jaxpr(arch, kv):
    jcfg, tcfg = mini_cfgs(arch, kv)
    params = jax.eval_shape(lambda: jax_lm.init(jax.random.key(0), jcfg))
    tokens = jax.ShapeDtypeStruct((TRAIN["global_batch"], TRAIN["seq_len"]),
                                  jnp.int32)
    jaxpr = jax.make_jaxpr(jax.value_and_grad(
        lambda p, t: jax_lm.loss_fn(p, jcfg, t)[0]))(params, tokens)
    want = dot_general_flops(jaxpr.jaxpr)
    rec = dryrun.dryrun_lm(arch, "train_4k", mesh=False, cfg=tcfg,
                           spec=TRAIN, verbose=False)
    assert rec["status"] == "ok" and rec["mesh"] is None
    got = rec["flops_by_phase"]["forward_backward"]
    assert abs(got - want) <= FLOP_BAR * want, (
        f"{arch}: {got:.6e} FLOPs against JAX's {want:.6e}; by op "
        f"{rec['flops_by_op']}")
