"""The window driver of CTR training cells.

Set-up builds one training object (the port's bundle for the cell's
placement, from ``embed.store.store_for(cfg).make_bundle``, with the
benchmark's weights and the state its ``init`` makes) and drives it
through its first three steps by the window's own call and feed
(``train.engine.run_epoch`` over ``data.prefetch.prefetch_chunks``, a
graph a chunk): a chunk of one batch, then a chunk of two, on the first
three batches of the pool. From the state those steps leave it reads the
numbers the reference is held to. Two more chunks capture the window's
graph and fill the pinned buffers; then the window runs epochs of the pool,
each shuffled by its own seed, as ``train.loop.train_ctr`` does, and ends
at the first chunk boundary past ``--seconds``, after a synchronise.
Once the window has closed and the peak memory has been read, the port's
state is freed and the reference runs the three steps again.
"""

from __future__ import annotations

import gc
import time

import torch

from .. import check, seeds
from ..generators import ctr as inputs
from ..reference import ctr as reference
from ..run_record import RunRecord
from ..trace import TRACE_AFTER_S, Stretch

PROBE_STEPS = 3
WARM_CHUNKS = 2


class _WindowClosed(Exception):
    """Raised from the window's hook to end ``run_epoch`` at a chunk
    boundary."""


def port_config(config: dict, traffic: dict):
    """The port's ``CTRConfig`` for the cell, as the CLI makes it."""
    from repro_torch.models.ctr import CTRConfig

    placement = traffic["placement"]
    return CTRConfig(
        name=config["model"], vocab_sizes=tuple(config["vocab_sizes"]),
        n_dense=config["n_dense"], emb_dim=config["emb_dim"],
        mlp_dims=tuple(config["mlp_dims"]), emb_sigma=config["emb_sigma"],
        sparse=placement == "sparse", placement=placement,
        compute_dtype=config["compute_dtype"])


def port_bundle(cfg, config: dict, traffic: dict):
    """The port's bundle for the cell: its scaling rule's hyperparameters
    from the config's base values, one Criteo epoch of dense warm-up (the
    CLI's), CowClip."""
    from repro_torch.core.scaling import scale_hyperparams
    from repro_torch.embed.store import store_for

    h = config["hyperparams"]
    batch = traffic["batch"]
    hp = scale_hyperparams(h["rule"], base_lr=h["base_lr"],
                           base_l2=h["base_l2"], base_batch=h["base_batch"],
                           batch_size=batch,
                           base_dense_lr=h["base_dense_lr"])
    return store_for(cfg).make_bundle(
        cfg, hp, clip_kind="adaptive_column", r=h["r"], zeta=h["zeta"],
        warmup_steps=max(1, h["epoch_rows"] // batch), b1=h["b1"],
        b2=h["b2"], eps=h["eps"])


def _broken(step, fault: str, cfg):
    """The step with a fault planted (for the checks that must fail)."""
    if fault == "unchanged":
        from repro_torch.models import ctr
        from repro_torch.train.metrics import logloss

        def unchanged(params, state, batch):
            z = ctr.apply(params, cfg, batch["ids"], batch["dense"])
            return params, state, {"loss": logloss(z, batch["labels"])}

        return unchanged
    if fault == "half_batch":
        def half(params, state, batch):
            n = batch["labels"].shape[0] // 2
            return step(params, state, {k: v[:n] for k, v in batch.items()})

        return half
    raise ValueError(f"unknown fault {fault!r}")


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _adam_mu(dense_state):
    """The first moments of the dense tower's Adam in the port's chain
    state (the one part with a ``mu``)."""
    parts = dense_state if isinstance(dense_state, tuple) else (dense_state,)
    for part in parts:
        if hasattr(part, "mu"):
            return part.mu
    raise ValueError("no Adam state in the dense tower's optimizer state")


def program_grads(params, state, hp: dict) -> dict:
    """The norm of each leaf's first gradient as the optimizer took it,
    from the state one step leaves: ``m / (1 - b1)``."""
    scale = 1.0 - hp["b1"]
    moments = {**{f"embed.{k}": v for k, v in _named(state["m"]).items()},
               **{f"dense.{k}": v
                  for k, v in _named(_adam_mu(state["dense"])).items()}}
    return {k: float((m.double() / scale).norm()) for k, m in moments.items()}


def program_change(params, start) -> dict:
    now, before = _named(params), _named(start)
    return {k: float((now[k].double() - before[k].double()).norm())
            for k in now}


def _dataset(pool: dict, vocabs, lo: int, hi: int):
    from repro_torch.data.synthetic import CTRDataset

    return CTRDataset(pool["ids"][lo:hi], pool["dense"][lo:hi],
                      pool["labels"][lo:hi], tuple(vocabs))


def _probe_batches(pool: dict, batch: int, device) -> list:
    return [{k: torch.as_tensor(pool[k][i * batch:(i + 1) * batch],
                                device=device)
             for k in ("ids", "dense", "labels")}
            for i in range(PROBE_STEPS)]


def reference_readings(config: dict, traffic: dict, pool: dict, seed: int,
                       device, *, tf32=False, half_batch=False) -> dict:
    """The reference's three steps from the seed's weights on the pool's
    first batches."""
    params = inputs.make_weights(config, seed, device)
    hp = reference.hyperparams(config, traffic["batch"])
    return reference.run_steps(
        params, _probe_batches(pool, traffic["batch"], device), config, hp,
        tf32=tf32, half_batch=half_batch)


def control(cell: str, config: dict, traffic: dict, *, seed: int, device,
            root, kind: str) -> dict:
    """The readings of the control (the reference in TF32 in the port's
    place) or of a fault planted in the reference put in its place
    (``half_batch``), against the reference: no window."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pool = inputs.make_traffic(dict(traffic, batches=PROBE_STEPS), config,
                               seed, device)
    want = reference_readings(config, traffic, pool, seed, device)
    got = reference_readings(config, traffic, pool, seed, device,
                             tf32=kind == "tf32",
                             half_batch=kind == "half_batch")
    gaps = check.training_gaps(got, want)
    ok, checks = check.judge(gaps, check.load_limits(root, cell))
    return {"correct": ok, "checks": checks, "gaps": gaps}


def run(cell: str, config: dict, traffic: dict, *, seed: int, seconds: float,
        trace: bool, device, root, t_start: float,
        fault: str | None = None) -> RunRecord:
    from repro_torch.train import engine

    if traffic["engine"] != "scan":
        raise ValueError(f"the CTR window drives the scan engine, not "
                         f"{traffic['engine']!r}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parts = {}
    mark = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - mark[0]
        mark[0] = now

    if cuda:
        from repro_torch.kernels.extension import build

        build()
    part("imports_and_build")
    batch, scan_steps = traffic["batch"], traffic["scan_steps"]
    vocabs = config["vocab_sizes"]
    hp_ref = reference.hyperparams(config, batch)

    pool = inputs.make_traffic(traffic, config, seed, dev)
    n_rows = len(pool["labels"])
    ds = _dataset(pool, vocabs, 0, n_rows)
    part("traffic")
    cfg = port_config(config, traffic)
    bundle = port_bundle(cfg, config, traffic)
    params = bundle.prepare(inputs.make_weights(config, seed, dev))
    state = bundle.init(params)
    step = engine.resolve_scan_step(bundle)
    if fault is not None:
        step = _broken(step, fault, cfg)
    part("weights_and_state")

    # the first steps, through the window's own call and feed
    losses = []

    def keep(k, aux):
        if aux is not None:
            losses.append(aux["loss"])

    first = {}
    for lo, hi in ((0, 1), (1, PROBE_STEPS)):
        runner = engine.make_chunk_runner(step)
        params, state, _, _ = engine.run_epoch(
            runner, params, state, _dataset(pool, vocabs, lo * batch,
                                            hi * batch),
            batch, scan_steps, shuffle=False, on_chunk=keep)
        del runner
        if lo == 0:
            first["grad"] = program_grads(params, state, hp_ref)
    params, state = bundle.flush(params, state)
    start = inputs.make_weights(config, seed, dev)
    first["change"] = program_change(params, start)
    del start
    first["losses"] = [float(x) for x in torch.cat(losses)]
    if cuda:
        torch.cuda.empty_cache()
    part("first_steps")

    # the window's graph and pinned buffers, then the window
    runner = engine.make_chunk_runner(step)
    engine.run_epoch(runner, params, state, ds, batch, scan_steps,
                     seed=seeds.derive(seed, "warm-up"),
                     max_steps=WARM_CHUNKS * scan_steps)
    if cuda:
        torch.cuda.synchronize()
    part("warm_up")
    setup_s = time.perf_counter() - t_start

    stretch = Stretch() if trace and cuda else None
    stretch_ids = []
    clock = {"steps": 0, "wait": 0.0, "after": None, "stretch_steps": 0,
             "chunks": 0}
    window_losses = []
    trace_chunks = traffic["trace_chunks"]

    def hook(k, aux):
        now = time.perf_counter()
        if aux is None:
            if clock["after"] is not None:
                clock["wait"] += now - clock["after"]
            if (stretch is not None and not stretch.active
                    and not stretch.done and now - t0 >= TRACE_AFTER_S):
                stretch.begin()
            if stretch is not None:
                stretch.close_span()
                stretch.span("chunk")
            return
        clock["steps"] += k
        window_losses.append(aux["loss"])
        if stretch is not None and stretch.active:
            clock["stretch_steps"] += k
            clock["chunks"] += 1
            if clock["chunks"] >= trace_chunks:
                stretch.end(clock["stretch_steps"])
            else:
                stretch.close_span()
                stretch.span("input wait")
        clock["after"] = time.perf_counter()
        if clock["after"] - t0 >= seconds and not (
                stretch is not None and stretch.active):
            raise _WindowClosed

    def traced(p, s, chunk):
        if stretch is not None and stretch.active:
            stretch_ids.append(chunk["ids"])
        return runner(p, s, chunk)

    epoch = 0
    t0 = time.perf_counter()
    try:
        while True:
            engine.run_epoch(traced, params, state, ds, batch, scan_steps,
                             seed=seeds.derive(seed, f"epoch {epoch}"),
                             on_chunk=hook)
            epoch += 1
    except _WindowClosed:
        pass
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    steps = clock["steps"]
    finite = torch.isfinite(torch.cat(window_losses)).sum().item()
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    record = RunRecord(
        family="ctr", setup_s=setup_s, window_s=window_s, steps=steps,
        failed=steps - int(finite), peak_bytes=peak,
        e2e={"train_rows_per_s": steps * batch / window_s,
             "peak_mem_gib": peak / 2**30, "setup_s": setup_s},
        input_wait_s=clock["wait"], stretch=stretch,
        notes={"setup_parts_s": parts, "epochs": epoch,
               "input_wait_s": clock["wait"]})
    if stretch is not None and stretch.done:
        record.work = _stretch_work(stretch_ids, vocabs, config, traffic)
    del stretch_ids, runner, params, state, bundle, step, ds
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    want = reference_readings(config, traffic, pool, seed, dev)
    gaps = check.training_gaps(first, want)
    record.correct, record.checks = check.judge(
        gaps, check.load_limits(root, cell))
    record.gaps = gaps
    record.notes["reference_s"] = time.perf_counter() - t_ref
    return record


def _stretch_work(chunks, vocabs, config, traffic) -> dict:
    """What the traced stretch's batches asked of the update and the
    embedding backward: each step's distinct ids a field."""
    touched = []
    for ids in chunks:
        for i in range(ids.shape[0]):
            touched.append([int(torch.unique(ids[i, :, f]).numel())
                            for f in range(len(vocabs))])
    return {"touched": touched, "vocabs": list(vocabs),
            "emb_dim": config["emb_dim"], "batch": traffic["batch"],
            "placement": traffic["placement"]}
