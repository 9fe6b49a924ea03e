"""The port's dry-run (``repro_torch.launch.dryrun``) on a fake 2 x 4
process group, on the CPU.

The mini dry-run of ``tests/test_dryrun_mini.py`` (the same five archs at
d_model 256, 8 heads, vocab 512, ``remat=True``; a train step at batch
8 x 64 and a decode step over a 128-slot cache) traced on fake tensors
sharded as DTensors (the recurrent archs and ``dryrun_ctr`` in
``test_torch_dryrun_recurrent.py``): every record ``"ok"`` with FLOPs, no collective in
the optimizer update (CowClip's row-local update), and the train step's
``argument_size_in_bytes`` exactly the per-rank block bytes of the
params, the substrate optimizer's state and the batch under JAX's specs
(``repro.sharding.specs`` on an ``AbstractMesh``) and leaf shapes.
``collective_stats`` of a
column- then row-parallel MLP is the one all-reduce of its output, and
``long_500k`` gives the reference's skip record for a full-attention
arch. JAX's own dry-run does not run on jax 0.9.0 (ROADMAP queue 3), so
the port is held to the parts of JAX that do.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.core import build_optimizer as jax_build_optimizer
from repro.core import scale_hyperparams as jax_scale_hyperparams
from repro.models import lm as jax_lm
from repro.sharding import specs as jax_specs
from jax.sharding import AbstractMesh
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import comm_analysis, dryrun
from repro_torch.launch.mesh import make_production_mesh

TRAIN = {"seq_len": 64, "global_batch": 8, "step": "train"}
DECODE = {"seq_len": 128, "global_batch": 8, "step": "decode"}
MINI = [("stablelm-3b", 8), ("gemma3-12b", 4), ("granite-moe-3b-a800m", 4),
        ("rwkv6-7b", 8), ("zamba2-2.7b", 8)]
# the attention and MoE archs here, the recurrent ones and deepfm-criteo in
# test_torch_dryrun_recurrent.py (each file well inside its time)
HERE = MINI[:3]
MESH = ((2, 4), ("data", "model"))


def mini_cfgs(arch, kv, **kw):
    """(JAX's, the port's) config of the mini dry-run."""
    kw = dict(d_model=256, n_heads=8, n_kv_heads=kv, vocab_size=512,
              remat=True, **kw)
    return (dataclasses.replace(jax_reduce_config(jax_get_config(arch)),
                                **kw),
            dataclasses.replace(reduce_config(get_config(arch)), **kw))


@pytest.fixture(scope="module")
def mesh():
    with make_production_mesh(shape=MESH[0], axes=MESH[1]) as m:
        yield m


def abstract_mesh():
    sizes, names = MESH
    try:
        return AbstractMesh(sizes, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))


def jax_block_bytes(tree, jmesh, spec_fn=jax_specs.param_spec) -> int:
    """Per-rank bytes of ``tree`` under JAX's specs: each leaf's block."""
    paths = jax.tree.leaves(jax_specs._paths_tree(tree))
    total = 0
    for p, leaf in zip(paths, jax.tree.leaves(tree)):
        spec = spec_fn(p, leaf.shape, jmesh)
        block = [d // _size(jmesh, a) for d, a in zip(leaf.shape, spec)]
        total += math.prod(block) * jnp.dtype(leaf.dtype).itemsize
    return total


def _size(jmesh, axis):
    if axis is None:
        return 1
    out = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        out *= jmesh.shape[a]
    return out


def batch_bytes(shape, itemsize, data=2):
    """A batch leaf's block: its first dim over "data" when it divides."""
    first = shape[0] // data if shape[0] % data == 0 else shape[0]
    return first * math.prod(shape[1:]) * itemsize


def check_record(rec):
    assert rec["status"] == "ok" and rec["flops"] > 0, rec
    assert rec["traced"] == ("plain versions; the Mamba-2 scan as one op, "
                             "by its shape function and FLOP formulas")
    assert rec["update_collectives"] == {}, rec["update_collectives"]
    assert rec["temp_size_in_bytes"] > 0 and rec["lower_s"] >= 0


def check_mini(arch, kv, mesh):
    """Train and decode on the fake 2 x 4 mesh; the train step's argument
    bytes are JAX's per-rank block bytes exactly. rwkv6-7b runs its
    chunked backend (the wkv6 wrapper's plain version; the token scan is
    the FLOP test's)."""
    kw = {"wkv_backend": "chunked"} if arch == "rwkv6-7b" else {}
    jcfg, tcfg = mini_cfgs(arch, kv, **kw)
    rec = dryrun.dryrun_lm(arch, "train_4k", mesh=mesh, cfg=tcfg,
                           spec=TRAIN, verbose=False)
    check_record(rec)
    assert rec["mesh"] == {"data": 2, "model": 4}
    # the optimizer has no product: every FLOP is the forward's/backward's
    assert rec["flops"] == rec["flops_by_phase"]["forward_backward"]
    assert rec["collective_bytes"] == sum(
        v["bytes"] for v in rec["collectives"].values()) > 0
    assert set(rec["collectives"]) <= set(comm_analysis.COLLECTIVES)

    jmesh = abstract_mesh()
    jparams = jax.eval_shape(lambda: jax_lm.init(jax.random.key(0), jcfg))
    hp = jax_scale_hyperparams("cowclip", base_lr=1e-4, base_l2=1e-5,
                               base_batch=1024, batch_size=4096)
    jopt = jax.eval_shape(jax_build_optimizer(hp, warmup_steps=100).init,
                          jparams)
    want = (jax_block_bytes(jparams, jmesh) + jax_block_bytes(jopt, jmesh)
            + batch_bytes((8, 64), 4))
    assert rec["argument_size_in_bytes"] == want

    rec = dryrun.dryrun_lm(arch, "decode_32k", mesh=mesh, cfg=tcfg,
                           spec=DECODE, verbose=False)
    check_record(rec)


@pytest.mark.parametrize("arch,kv", HERE, ids=[a for a, _ in HERE])
def test_torch_mini_dryrun_train_and_decode(arch, kv, mesh):
    check_mini(arch, kv, mesh)


def test_torch_collective_stats_column_then_row_mlp(mesh):
    """``relu(x @ w1) @ w2`` with ``w1`` split by columns and ``w2`` by
    rows over "model" (x [16, 64] split by rows over "data"): the one
    collective is the all-reduce over "model" of the [8, 64] f32 output
    block, 2048 bytes; the FLOPs are one rank's: 2 * 8 * 64 * 32 twice."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with FakeTensorMode():
        x = distribute_tensor(torch.empty(16, 64), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w1 = distribute_tensor(torch.empty(64, 128), mesh,
                               [Replicate(), Shard(1)], src_data_rank=None)
        w2 = distribute_tensor(torch.empty(128, 64), mesh,
                               [Replicate(), Shard(0)], src_data_rank=None)
        with comm_analysis.StepTrace() as tr:
            y = torch.relu(x @ w1) @ w2
            y = y.redistribute(mesh, [Shard(0), Replicate()])
    assert comm_analysis.collective_stats(tr.collectives) == {
        "all-reduce": {"count": 1, "bytes": 8 * 64 * 4}}
    assert comm_analysis.total_collective_bytes(tr.collectives) == 2048
    assert tr.total_flops() == 2 * (2 * 8 * 64 * 32)
    assert tuple(y.to_local().shape) == (8, 64)


def test_torch_long_500k_skips_full_attention():
    """The reference's skip record, with no mesh made."""
    assert dryrun.dryrun_lm("stablelm-3b", "long_500k", verbose=False) == {
        "arch": "stablelm-3b", "shape": "long_500k", "multi_pod": False,
        "status": "skipped",
        "reason": "full-attention arch; long_500k requires sub-quadratic "
                  "attention (DESIGN.md)"}
