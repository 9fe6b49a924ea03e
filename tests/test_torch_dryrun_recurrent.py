"""The port's dry-run on a fake 2 x 4 process group, on the CPU: the
mini dry-run's recurrent archs (rwkv6-7b, zamba2-2.7b) and
``dryrun_ctr`` at a reduced size (deepfm-criteo's params and Adam state
placed by the LM engine, as the reference's dry-run places them), held as
in ``test_torch_dryrun.py``."""

import dataclasses
import math

import jax
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import build_optimizer as jax_build_optimizer
from repro.core import scale_hyperparams as jax_scale_hyperparams
from repro.models import ctr as jax_ctr
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from test_torch_dryrun import (MINI, abstract_mesh, batch_bytes,  # noqa: F401
                               check_mini, check_record, jax_block_bytes,
                               mesh)

HERE = MINI[3:]


@pytest.mark.parametrize("arch,kv", HERE, ids=[a for a, _ in HERE])
def test_torch_mini_dryrun_recurrent_train_and_decode(arch, kv, mesh):
    check_mini(arch, kv, mesh)


def test_torch_mini_dryrun_ctr(mesh):
    """deepfm-criteo with its vocabs capped at 1024, batch 2048, on the
    fake mesh: its params and Adam state placed by the LM engine, the
    substrate step; argument bytes JAX's exactly."""
    small = tuple(min(v, 1024) for v in get_config("deepfm-criteo")
                  .vocab_sizes)
    tcfg = dataclasses.replace(get_config("deepfm-criteo"),
                               vocab_sizes=small)
    jcfg = dataclasses.replace(jax_get_config("deepfm-criteo"),
                               vocab_sizes=small)
    rec = dryrun.dryrun_ctr("ctr_8k", mesh=mesh, cfg=tcfg, batch=2048,
                            verbose=False)
    check_record(rec)
    assert rec["arch"] == "deepfm-criteo"
    jmesh = abstract_mesh()
    jparams = jax.eval_shape(lambda: jax_ctr.init(jax.random.key(0), jcfg))
    hp = jax_scale_hyperparams("cowclip", base_lr=1e-4, base_l2=1e-5,
                               base_batch=1024, batch_size=2048)
    jopt = jax.eval_shape(jax_build_optimizer(hp).init, jparams)
    want = (jax_block_bytes(jparams, jmesh) + jax_block_bytes(jopt, jmesh)
            + batch_bytes((2048, jcfg.n_fields), 4)
            + batch_bytes((2048, jcfg.n_dense), 4)
            + batch_bytes((2048,), 4))
    assert rec["argument_size_in_bytes"] == want
    assert rec["params_total"] == sum(
        math.prod(x.shape) for x in jax.tree.leaves(jparams))
