"""Multi-pod dry-run: trace every (arch x input shape) step on the
production mesh with NO allocation, and report what one rank would
compute, hold and communicate. The port of ``repro.launch.dryrun``.

The reference lowers and compiles each step on 512 simulated host devices
and reads XLA's memory and cost analyses. Here the step runs once on fake
tensors (``FakeTensorMode``: shapes and dtypes, no storage) on the CPU,
its params, optimizer state, batch and cache sharded as DTensors by the
reference's rules (``sharding.specs``) over a ``DeviceMesh`` on a fake
process group of 256 or 512 ranks (``launch.mesh.make_production_mesh``),
with the model's activation constraints live (``sharding.act.use_mesh``).
``launch.comm_analysis.StepTrace`` counts, per rank, the FLOPs, bytes,
peak live storage and the collectives that DTensor's redistributions
issue. It is a host analysis, as the reference's is, not a fallback from
the card: on fake CPU tensors every kernel wrapper takes its plain
version, so the plain versions are what is counted, as the reference
lowers its jnp twins and the substrate optimizer, never a Pallas kernel.
The Mamba-2 scan is the exception: it is one op of the port
(``kernels/ssd/ops.py``), which runs its shape function on fake tensors,
once a layer, and is counted by its FLOP formulas (the plain loop's
``states @ c`` product) and its operand and result bytes (``"traced"``
in each record says so). With ``mesh=None`` the same trace runs
unsharded (one rank).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepfm-criteo --shape ctr_128k
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import torch

from ..configs import (
    ASSIGNED_ARCHS,
    INPUT_SHAPES,
    get_config,
    input_specs,
    supports_long_context,
)
from ..core.builders import build_optimizer
from ..core.optim import GradientTransformation
from ..core.scaling import scale_hyperparams
from ..core.tree import tree_leaves, tree_map
from ..models import ctr as ctr_lib, lm
from ..sharding.act import use_mesh
from ..sharding.specs import (
    axis_sizes,
    infer_cache_shardings,
    infer_param_shardings,
    to_placements,
)
from . import comm_analysis
from .mesh import make_production_mesh

TRACED = ("plain versions; the Mamba-2 scan as one op, by its shape "
          "function and FLOP formulas")
# rwkv6's sequence backend in the CLI's records: the port's training
# default; its token scan is a Python loop a token, which takes hours to
# trace at 4096 tokens and 32 layers
CLI_WKV_BACKEND = "chunked"


# --------------------------------------------------------------------------
# step functions under dry-run
# --------------------------------------------------------------------------


def _make_lm_optimizer(cfg: lm.LMConfig):
    """The paper's technique on the LM token table: CowClip on the
    embedding group, sqrt-scaled Adam on the dense tower; the LM batch is
    counted in tokens (the unit CowClip scales by). ``(hp, tx)``."""
    del cfg
    shape = INPUT_SHAPES["train_4k"]
    token_batch = shape["global_batch"] * shape["seq_len"]
    hp = scale_hyperparams(
        "cowclip", base_lr=1e-4, base_l2=1e-5, base_batch=1024,
        batch_size=token_batch, base_dense_lr=8e-4,
    )
    return hp, build_optimizer(hp, clip_kind="adaptive_column", zeta=1e-5,
                               warmup_steps=100)


def make_lm_train_step(cfg: lm.LMConfig, tx, hp, *,
                       bf16_gather: bool = False):
    """``train.loop.make_lm_train_step`` in its substrate form (``tx``
    over the whole tree, CowClip's counts from the batch's tokens) as
    ``step(params, opt_state, batch) -> (params, opt_state, loss)``.
    ``bf16_gather`` casts the dense params to bf16 before the forward, so
    a sharded weight is gathered in 2 bytes instead of 4 (masters and
    optimizer stay f32)."""
    from ..train.loop import make_lm_train_step as loop_step

    step, _ = loop_step(cfg, hp, tx=tx, dense_dtype=(
        torch.bfloat16 if bf16_gather else None))

    def train_step(params, opt_state, batch):
        params, opt_state, aux = step(params, opt_state, {
            "tokens": batch["tokens"], "prefix": batch.get("prefix_emb")})
        return params, opt_state, aux["loss"]

    return train_step


def make_lm_prefill(cfg: lm.LMConfig):
    def prefill_step(params, batch):
        return lm.prefill(params, cfg, batch["tokens"],
                          batch.get("prefix_emb"))

    return prefill_step


def make_lm_decode(cfg: lm.LMConfig):
    def serve_step(params, cache, token, cur_index):
        return lm.decode_step(params, cfg, token, cache, cur_index)

    return serve_step


def _as_param(g, p):
    """A gradient (or a table's ``[V]`` counts) laid out as its param:
    the reduce-scatter of a partial sum over the batch's mesh dims."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(g, DTensor) or not isinstance(p, DTensor):
        return g
    lay = [pl if not isinstance(pl, Shard) or pl.dim < g.dim()
           else Replicate() for pl in p.placements]
    return g.redistribute(p.device_mesh, lay)


def _phased(tx, trace_ref: list):
    """``tx`` whose ``update`` first lays the gradients and CowClip's
    counts out as their params (the end of the backward, as an SPMD
    partitioner reduces gradients into the params' layout), then switches
    the trace's phase to ``"update"``: what the optimizer itself issues is
    recorded apart from the forward and backward."""
    def update(grads, state, params, **kwargs):
        grads = tree_map(_as_param, grads, params)
        if kwargs.get("counts") is not None:
            kwargs["counts"] = tree_map(_as_param, kwargs["counts"],
                                        params["embed"])
        if trace_ref:
            trace_ref[0].phase = "update"
        return tx.update(grads, state, params, **kwargs)

    return GradientTransformation(tx.init, update)


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------


def _distribute(tree, specs, mesh):
    """Each leaf as a DTensor placed by its spec (no collective: every
    rank cuts its own block), or the tree as it is without a mesh."""
    if mesh is None:
        return tree
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda t, spec: distribute_tensor(
        t, mesh, to_placements(spec, mesh), src_data_rank=None), tree, specs)


def _batch_specs(tree, mesh):
    """Leading dim over the data axes where it divides them, else
    replicated (the reference's ``_batch_sharding``)."""
    sizes = axis_sizes(mesh)
    data = ("pod", "data") if "pod" in sizes else ("data",)
    n = 1
    for a in data:
        n *= sizes[a]
    first = (data if len(data) > 1 else data[0])

    def spec(t):
        if t.dim() == 0:
            return ()
        return ((first if t.shape[0] % n == 0 else None),) \
            + (None,) * (t.dim() - 1)

    return tree_map(spec, tree)


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _bytes(tree) -> int:
    return sum(_local(t).numel() * _local(t).element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


@contextlib.contextmanager
def _fake_trace(mesh):
    """Fake tensors on the CPU, the mesh for ``constrain``, and plain
    tensors made inside the model (its zeros, its aranges) taken as
    replicated beside DTensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode, is_fake

    from ..core import optim
    from ..kernels.embedding import field_layout

    def drop_fake_caches():
        field_layout.cache_clear()
        for key in [k for k, t in optim._BIAS_TABLES.items() if is_fake(t)]:
            del optim._BIAS_TABLES[key]

    with contextlib.ExitStack() as stack:
        # cached tensors: the layouts' made outside the trace stay out;
        # none made inside (fake) outlives it. Adam's bias table is built
        # on the host first (its ~17k scalar steps are not the step's
        # work), and read inside as a real input.
        field_layout.cache_clear()
        optim._bias_table(0.9, 0.999, "cpu")
        stack.callback(drop_fake_caches)
        stack.enter_context(FakeTensorMode(allow_non_fake_inputs=True))
        if mesh is not None:
            from torch.distributed.tensor.experimental import (
                implicit_replication)

            stack.enter_context(use_mesh(mesh))
            stack.enter_context(implicit_replication())
        yield


def _run(fn, args, *, grad: bool, trace_ref: list):
    """``fn(*args)`` under a ``StepTrace`` that leaves the arguments'
    storages out of the temp bytes. ``(out, trace, seconds)``."""
    tr = comm_analysis.StepTrace()
    tr.ignore([_local(t) for t in tree_leaves(args)
               if isinstance(t, torch.Tensor)])
    trace_ref[:] = [tr]
    tr.phase = "forward_backward" if grad else "forward"
    t0 = time.perf_counter()
    with tr, torch.set_grad_enabled(grad):
        out = fn(*args)
    return out, tr, time.perf_counter() - t0


# --------------------------------------------------------------------------
# dry-run core
# --------------------------------------------------------------------------


def lower_for(cfg, shape_name: str, mesh, *, bf16_gather: bool = False,
              spec: dict | None = None, force_remat: bool = True):
    """Build, place and trace the step for ``(cfg, shape)`` on ``mesh``
    (None: one rank). Training forces ``remat=True`` (superblock
    activation checkpointing), as the reference does, unless
    ``force_remat`` is False (then ``cfg.remat`` holds). ``spec`` stands
    in for ``INPUT_SHAPES[shape_name]``. Returns ``(trace, seconds,
    argument_bytes, output_bytes)``."""
    spec = spec or INPUT_SHAPES[shape_name]
    if spec["step"] == "train" and force_remat:
        cfg = dataclasses.replace(cfg, remat=True)
    trace_ref: list = []
    with _fake_trace(mesh):
        params = lm.init(cfg, device="cpu")
        p_specs = None if mesh is None else infer_param_shardings(params,
                                                                  mesh)
        inputs = input_specs(cfg, shape_name, device="cpu", spec=spec)
        if spec["step"] == "train":
            hp, tx = _make_lm_optimizer(cfg)
            opt = tx.init(params)
            o_specs = None if mesh is None else infer_param_shardings(
                opt, mesh)
            params = _distribute(params, p_specs, mesh)
            opt = _distribute(opt, o_specs, mesh)
            batch = _distribute(inputs, None if mesh is None
                                else _batch_specs(inputs, mesh), mesh)
            fn = make_lm_train_step(cfg, _phased(tx, trace_ref), hp,
                                    bf16_gather=bf16_gather)
            args, grad = (params, opt, batch), True
        elif spec["step"] == "prefill":
            params = _distribute(params, p_specs, mesh)
            batch = _distribute(inputs, None if mesh is None
                                else _batch_specs(inputs, mesh), mesh)
            fn, args, grad = make_lm_prefill(cfg), (params, batch), False
        else:
            cache = inputs["cache"]
            params = _distribute(params, p_specs, mesh)
            cache = _distribute(cache, None if mesh is None
                                else infer_cache_shardings(cache, mesh),
                                mesh)
            token = _distribute(inputs["token"], None if mesh is None
                                else _batch_specs(inputs["token"], mesh),
                                mesh)
            fn = make_lm_decode(cfg)
            args, grad = (params, cache, token, inputs["cur_index"]), False
        out, tr, seconds = _run(fn, args, grad=grad, trace_ref=trace_ref)
        return tr, seconds, _bytes(args), _bytes(out)


def dryrun_lm(arch: str, shape_name: str, *, multi_pod: bool = False,
              mesh=None, verbose: bool = True, cfg=None,
              bf16_gather: bool = False, spec: dict | None = None,
              force_remat: bool = True,
              wkv_backend: str | None = None) -> dict:
    """One (arch, shape) record. ``mesh``: the mesh to trace on (None:
    the production mesh of ``multi_pod``; False: one rank, unsharded).
    ``cfg`` and ``spec`` stand in for the arch's config and the shape's
    ``INPUT_SHAPES`` entry (the tests' reduced sizes); ``force_remat``
    as ``lower_for``'s; ``wkv_backend`` replaces the config's."""
    cfg = cfg or get_config(arch)
    if wkv_backend is not None:
        cfg = dataclasses.replace(cfg, wkv_backend=wkv_backend)
    spec = spec or INPUT_SHAPES[shape_name]
    if spec["step"] == "decode" and shape_name == "long_500k" \
            and not supports_long_context(cfg):
        return {
            "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "status": "skipped",
            "reason": "full-attention arch; long_500k requires "
                      "sub-quadratic attention (DESIGN.md)",
        }
    with _mesh_or(mesh, multi_pod) as m:
        tr, seconds, arg_b, out_b = lower_for(cfg, shape_name, m,
                                              bf16_gather=bf16_gather,
                                              spec=spec,
                                              force_remat=force_remat)
        rec = _report(arch, shape_name, multi_pod, m, tr, seconds, arg_b,
                      out_b, lm.param_counts(cfg), verbose)
        if "rwkv6" in cfg.block_pattern:
            rec["wkv_backend"] = cfg.wkv_backend
        return rec


@contextlib.contextmanager
def _mesh_or(mesh, multi_pod: bool):
    if mesh is False:
        yield None
    elif mesh is not None:
        yield mesh
    else:
        with make_production_mesh(multi_pod=multi_pod) as m:
            yield m


def dryrun_ctr(shape_name: str = "ctr_128k", *, multi_pod: bool = False,
               mesh=None, verbose: bool = True, cfg=None,
               batch: int | None = None) -> dict:
    """The paper's own model at its headline 128K batch, distributed: its
    params and Adam state placed by ``infer_param_shardings`` (the LM
    engine, as the reference's dry-run does), the substrate step
    (``train.loop.make_train_step`` over ``build_optimizer``)."""
    from ..train.loop import make_train_step

    cfg = cfg or get_config("deepfm-criteo")
    batch = batch or {"ctr_128k": 131072, "ctr_8k": 8192}[shape_name]
    hp = scale_hyperparams("cowclip", base_lr=1e-4, base_l2=1e-5,
                           base_batch=1024, batch_size=batch,
                           base_dense_lr=8e-4)
    tx = build_optimizer(hp, clip_kind="adaptive_column", zeta=1e-5)
    trace_ref: list = []
    with _mesh_or(mesh, multi_pod) as m, _fake_trace(m):
        params = ctr_lib.init(cfg, device="cpu")
        opt = tx.init(params)
        inputs = {
            "ids": torch.zeros((batch, cfg.n_fields), dtype=torch.int32),
            "dense": torch.zeros((batch, cfg.n_dense)),
            "labels": torch.zeros((batch,)),
        }
        if m is not None:
            params = _distribute(params, infer_param_shardings(params, m), m)
            opt = _distribute(opt, infer_param_shardings(opt, m), m)
            inputs = _distribute(inputs, _batch_specs(inputs, m), m)
        step = make_train_step(cfg, _phased(tx, trace_ref))
        n_params = sum(t.numel() for t in tree_leaves(params))
        args = (params, opt, inputs)
        out, tr, seconds = _run(step, args, grad=True, trace_ref=trace_ref)
        return _report("deepfm-criteo", shape_name, multi_pod, m, tr,
                       seconds, _bytes(args), _bytes(out),
                       {"total": n_params, "active": n_params}, verbose)


def _report(arch, shape_name, multi_pod, mesh, tr, seconds, arg_bytes,
            out_bytes, counts, verbose) -> dict:
    """The reference's record keys, per rank: ``flops`` (FlopCounterMode's
    formulas on the rank's local ops), ``bytes_accessed``,
    ``collectives`` / ``collective_bytes`` (executed counts; ``loop_scale``
    1), the argument, output and temp (peak live storage made in the step)
    bytes; ``lower_s`` the trace's seconds. Besides: the update's own
    collectives (``update_collectives``; CowClip's row-local update should
    issue none), the FLOPs by phase, and the mesh."""
    coll = comm_analysis.collective_stats(tr.collectives)
    upd = comm_analysis.collective_stats(
        [c for c in tr.collectives if c["phase"] == "update"])
    rec = {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "status": "ok",
        "traced": TRACED,
        "mesh": None if mesh is None else axis_sizes(mesh),
        "params_total": counts["total"],
        "params_active": counts["active"],
        "flops": float(tr.total_flops()),
        "flops_by_phase": {k: float(v) for k, v in tr.flops.items()},
        "flops_by_op": {k: float(v) for k, v in tr.flops_by_op.items()},
        "bytes_accessed": float(tr.bytes_accessed),
        "collectives": coll,
        "collective_bytes": sum(v["bytes"] for v in coll.values()),
        "update_collectives": upd,
        "loop_scale": 1,
        "lower_s": round(seconds, 2),
        "argument_size_in_bytes": int(arg_bytes),
        "output_size_in_bytes": int(out_bytes),
        "temp_size_in_bytes": int(tr.peak_temp_bytes),
        "temp_by_phase": dict(tr.peak_by_phase),
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} (multi_pod={multi_pod}): OK "
              f"trace={seconds:.1f}s")
        print(f"  memory: { {k: v for k, v in rec.items() if k.endswith('_in_bytes')} }")
        print(f"  flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e}")
        print(f"  collectives: {coll}; in the update: {upd}")
    return rec


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def _failed(arch, shape_name, multi_pod, e) -> dict:
    print(f"[dryrun] {arch} x {shape_name}: FAILED — {e}")
    return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "status": "FAILED", "error": f"{type(e).__name__}: {e}"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None,
                    help="architecture id (see repro_torch.configs), or "
                         "deepfm-criteo")
    ap.add_argument("--shape", default="train_4k",
                    help="|".join(list(INPUT_SHAPES) + ["ctr_128k",
                                                        "ctr_8k"]))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all (arch x shape) pairs on the selected mesh")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)
    bf16_gather = os.environ.get("REPRO_BF16_GATHER", "0") == "1"

    def emit(rec):
        records.append(rec)
        if args.out:     # a record a line as it comes: a long sweep keeps
            with open(args.out, "a") as f:     # what it has reached
                f.write(json.dumps(rec) + "\n")

    records: list = []
    with make_production_mesh(multi_pod=args.multi_pod) as mesh:
        if args.all:
            for arch in ASSIGNED_ARCHS:
                for shape_name in INPUT_SHAPES:
                    try:
                        rec = dryrun_lm(arch, shape_name,
                                        multi_pod=args.multi_pod, mesh=mesh,
                                        bf16_gather=bf16_gather,
                                        wkv_backend=CLI_WKV_BACKEND)
                    except Exception as e:  # a failure here is a bug to fix
                        rec = _failed(arch, shape_name, args.multi_pod, e)
                    emit(rec)
            try:
                emit(dryrun_ctr("ctr_128k", multi_pod=args.multi_pod,
                                mesh=mesh))
            except Exception as e:
                emit(_failed("deepfm-criteo", "ctr_128k", args.multi_pod, e))
        elif args.arch == "deepfm-criteo" or args.shape.startswith("ctr_"):
            emit(dryrun_ctr(args.shape, multi_pod=args.multi_pod, mesh=mesh))
        else:
            emit(dryrun_lm(args.arch, args.shape, multi_pod=args.multi_pod,
                           mesh=mesh, bf16_gather=bf16_gather,
                           wkv_backend=CLI_WKV_BACKEND))
    bad = [r for r in records if r["status"] == "FAILED"]
    if bad:
        raise SystemExit(f"{len(bad)} dry-run failures")


if __name__ == "__main__":
    main()
