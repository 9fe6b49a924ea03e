"""The port's sharding rules (``repro_torch.sharding``) against the JAX
package's, on the CPU.

``param_spec`` and ``cache_spec`` are held to ``repro.sharding.specs``
leaf for leaf, by path, on the abstract production meshes of
``tests/test_sharding.py`` (16 x 16 and 2 x 16 x 16): every arch's params
(built on the ``meta`` device here, by ``jax.eval_shape`` there), the
substrate optimizer's state tree, every arch's decode cache, and
deepfm-criteo's params. On a fake 2 x 4 process group, each rank's block
of a DTensor placed by ``to_placements`` has the shape JAX's spec
implies. ``constrain`` without a mesh returns its input itself.
"""

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.core import build_optimizer as jax_build_optimizer
from repro.core import scale_hyperparams as jax_scale_hyperparams
from repro.models import ctr as jax_ctr
from repro.models import lm as jax_lm
from repro.sharding import specs as jax_specs
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.builders import build_optimizer
from repro_torch.core.scaling import scale_hyperparams
from repro_torch.core.tree import flatten_with_paths
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import ctr, lm
from repro_torch.sharding import act, specs

MESHES = {
    "1pod": ((16, 16), ("data", "model")),
    "2pod": ((2, 16, 16), ("pod", "data", "model")),
}
HP = dict(base_lr=1e-4, base_l2=1e-5, base_batch=1024, batch_size=4096)


def _abstract_mesh(sizes, names):
    try:
        return AbstractMesh(sizes, names)            # jax >= 0.5 signature
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))  # 0.4.x: ((name, n),)


def _norm(spec) -> tuple:
    """A spec as a tuple, each entry None, an axis name, or a tuple of
    two or more (a one-axis tuple is that axis)."""
    out = []
    for axis in spec:
        if isinstance(axis, (tuple, list)):
            axis = tuple(axis)
            axis = axis[0] if len(axis) == 1 else axis
        out.append(axis)
    return tuple(out)


def _jax_specs(tree, mesh, spec_fn) -> dict:
    paths = jax.tree.leaves(jax_specs._paths_tree(tree))
    return {p: (tuple(leaf.shape), _norm(spec_fn(p, leaf.shape, mesh)))
            for p, leaf in zip(paths, jax.tree.leaves(tree))}


def _port_specs(tree, sizes, spec_fn) -> dict:
    return {p: (tuple(t.shape), _norm(spec_fn(p, tuple(t.shape), sizes)))
            for p, t in flatten_with_paths(tree).items()}


def _assert_same(want: dict, got: dict, what: str):
    assert sorted(want) == sorted(got), f"{what}: leaf paths differ"
    bad = {p: (want[p], got[p]) for p in want if want[p] != got[p]}
    assert not bad, f"{what}: {len(bad)} leaves differ, e.g. " \
                    f"{next(iter(bad.items()))}"


def _meshes(name):
    sizes, names = MESHES[name]
    return _abstract_mesh(sizes, names), dict(zip(names, sizes))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_torch_param_and_cache_specs_match_jax(arch, mesh_name):
    """Every param leaf and every decode-cache leaf (batch 128, 1024
    positions) gets JAX's spec, by path."""
    jmesh, sizes = _meshes(mesh_name)
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    want = _jax_specs(jax.eval_shape(lambda: jax_lm.init(
        jax.random.key(0), jcfg)), jmesh, jax_specs.param_spec)
    got = _port_specs(lm.init(tcfg, device="meta"), sizes, specs.param_spec)
    _assert_same(want, got, f"{arch} params")
    want = _jax_specs(jax.eval_shape(lambda: jax_lm.init_cache(
        jcfg, 128, 1024)), jmesh, jax_specs.cache_spec)
    got = _port_specs(lm.init_cache(tcfg, 128, 1024, device="meta"), sizes,
                      specs.cache_spec)
    _assert_same(want, got, f"{arch} cache")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["gemma3-12b", "granite-moe-3b-a800m",
                                  "rwkv6-7b", "zamba2-2.7b"])
def test_torch_optimizer_state_specs_match_jax(arch, mesh_name):
    """The substrate optimizer's state (the token table's clip and Adam
    state, the dense tower's Adam and warm-up counters) leaf for leaf."""
    jmesh, sizes = _meshes(mesh_name)
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    jparams = jax.eval_shape(lambda: jax_lm.init(jax.random.key(0), jcfg))
    jtx = jax_build_optimizer(jax_scale_hyperparams("cowclip", **HP),
                              warmup_steps=100)
    tx = build_optimizer(scale_hyperparams("cowclip", **HP),
                         warmup_steps=100)
    want = _jax_specs(jax.eval_shape(jtx.init, jparams), jmesh,
                      jax_specs.param_spec)
    got = _port_specs(tx.init(lm.init(tcfg, device="meta")), sizes,
                      specs.param_spec)
    _assert_same(want, got, f"{arch} optimizer state")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_torch_ctr_specs_match_jax(mesh_name):
    """deepfm-criteo's params through the LM engine (what the dry-run
    shards them with) and through ``ctr_param_spec``, re-exported."""
    jmesh, sizes = _meshes(mesh_name)
    jparams = jax.eval_shape(lambda: jax_ctr.init(
        jax.random.key(0), jax_get_config("deepfm-criteo")))
    params = ctr.init(get_config("deepfm-criteo"), device="meta")
    _assert_same(_jax_specs(jparams, jmesh, jax_specs.param_spec),
                 _port_specs(params, sizes, specs.param_spec),
                 "deepfm-criteo params")
    want = _jax_specs(jparams, jmesh, jax_specs.ctr_param_spec)
    got = {p: (tuple(t.shape), specs.ctr_param_spec(p, tuple(t.shape),
                                                    sizes["model"]))
           for p, t in flatten_with_paths(params).items()}
    _assert_same(want, got, "deepfm-criteo ctr_param_spec")


def test_torch_batch_spec_matches_jax():
    for name in MESHES:
        jmesh, sizes = _meshes(name)
        assert _norm(specs.batch_spec(sizes)) == _norm(
            jax_specs.batch_spec(jmesh))


@pytest.mark.parametrize("rank", [0, 3, 5, 7])
def test_torch_placements_give_jax_local_shapes(rank):
    """On a fake 2 x 4 group, playing ``rank``: every param and Adam leaf
    of the reduced gemma3-12b (d_model 256, 8 heads, kv 4: row, FSDP, TP
    and the folded ("model", "data") row rule all occur), distributed by
    ``to_placements`` of its spec, has the block JAX's spec implies."""
    import dataclasses

    from torch.distributed.tensor import distribute_tensor

    jcfg = dataclasses.replace(jax_reduce_config(jax_get_config(
        "gemma3-12b")), d_model=256, n_heads=8, n_kv_heads=4)
    tcfg = dataclasses.replace(reduce_config(get_config("gemma3-12b")),
                               d_model=256, n_heads=8, n_kv_heads=4)
    jmesh = _abstract_mesh((2, 4), ("data", "model"))
    jparams = jax.eval_shape(lambda: jax_lm.init(jax.random.key(0), jcfg))
    want = {p: tuple(d // _size(jmesh, a) for d, a in zip(shape, spec))
            for p, (shape, spec) in _jax_specs(
                jparams, jmesh, jax_specs.param_spec).items()}
    seen = set()
    with make_production_mesh(shape=(2, 4), axes=("data", "model"),
                              rank=rank) as mesh:
        for p, t in flatten_with_paths(lm.init(tcfg, device="meta")).items():
            spec = specs.param_spec(p, tuple(t.shape), mesh)
            pl = specs.to_placements(spec, mesh)
            got = tuple(distribute_tensor(t, mesh, pl,
                                          src_data_rank=None)
                        .to_local().shape)
            assert got == want[p] == specs.local_shape(t.shape, spec,
                                                       mesh), (p, spec)
            seen.add(_norm(spec))
    assert (("model", "data"), None) in seen and ("data", "model") in seen


def _size(mesh, axis):
    if axis is None:
        return 1
    axes = axis if isinstance(axis, tuple) else (axis,)
    out = 1
    for a in axes:
        out *= mesh.shape[a]
    return out


def test_torch_constrain_without_mesh_is_identity():
    x = torch.ones(2, 3, 4)
    assert act.current_mesh() is None
    assert act.constrain(x, "batch", None, "model") is x
    assert act.constrain(x, "batch") is x           # rank mismatch
    with make_production_mesh(shape=(2, 4), axes=("data", "model")) as mesh:
        with act.use_mesh(mesh):
            assert act.current_mesh() is mesh
            # a plain tensor on a mesh is left as it is too
            assert act.constrain(x, "batch", None, "model") is x
        assert act.current_mesh() is None
