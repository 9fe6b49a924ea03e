"""The window driver of LM training cells.

Set-up builds one training object: the port's step and its state from
``train.loop.make_lm_train_step(cfg, hp, warmup_steps=...)`` (the step of
``train_lm``, the CLI's ``--task lm``), with the benchmark's weights. It
drives that step through its first three steps on the stream's first
three ``[batch, seq]`` slices, and from the state they leave reads the
numbers the reference is held to; two more steps warm up. The window then
steps over the next slices, the stream restarting at its end as
``train_lm``'s does, the loss left on the card, and ends at the first step
boundary past ``--seconds``, after a synchronise. Once the window has
closed and the peak memory has been read, the port's state is freed and
the reference runs the three steps again.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from .. import check
from ..generators import lm as inputs
from ..reference import rwkv6 as reference
from ..run_record import RunRecord
from ..trace import TRACE_AFTER_S, Stretch
from .ctr import _adam_mu, _named, program_change

PROBE_STEPS = 3
WARM_STEPS = 2


def port_config(config: dict):
    """The port's ``LMConfig``: its published rwkv6-7b with the file's
    keys in place (the depth, the scan's backend, the precision)."""
    from repro_torch.configs.rwkv6_7b import CONFIG

    keys = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
            "vocab_size", "compute_dtype", "wkv_backend", "remat",
            "norm_eps", "emb_sigma")
    return dataclasses.replace(CONFIG, **{k: config[k] for k in keys},
                               block_pattern=tuple(config["block_pattern"]))


def port_step(cfg, config: dict, traffic: dict):
    from repro_torch.core.scaling import scale_hyperparams
    from repro_torch.train.loop import make_lm_train_step

    h = config["hyperparams"]
    hp = scale_hyperparams(h["rule"], base_lr=h["base_lr"],
                           base_l2=h["base_l2"], base_batch=h["base_batch"],
                           batch_size=traffic["batch"] * traffic["seq"],
                           base_dense_lr=h["base_dense_lr"])
    return make_lm_train_step(cfg, hp, r=h["r"], zeta=h["zeta"],
                              warmup_steps=h["warmup_steps"])


def _broken(step, fault: str, cfg):
    if fault == "unchanged":
        from repro_torch.models import lm

        def unchanged(params, state, batch):
            with torch.no_grad():
                value = lm.loss_fn(params, cfg, batch["tokens"])[0]
            return params, state, {"loss": value}

        return unchanged
    if fault == "half_batch":
        def half(params, state, batch):
            n = batch["tokens"].shape[0] // 2
            return step(params, state, {"tokens": batch["tokens"][:n],
                                        "prefix": None})

        return half
    raise ValueError(f"unknown fault {fault!r}")


def program_grads(state, hp: dict) -> dict:
    scale = 1.0 - hp["b1"]
    moments = {"embed.tokens": state["m"]["tokens"],
               **{f"dense.{k}": v
                  for k, v in _named(_adam_mu(state["dense"])).items()}}
    return {k: float((m.double() / scale).norm()) for k, m in moments.items()}


def reference_readings(config, traffic, tokens, seed, device, *, fp8=False,
                       half_batch=False) -> dict:
    params = inputs.make_weights(config, seed, device)
    hp = reference.hyperparams(config, traffic["batch"] * traffic["seq"])
    out = reference.run_steps(params, [tokens[i] for i in range(PROBE_STEPS)],
                              config, hp, fp8=fp8, half_batch=half_batch)
    start = inputs.make_weights(config, seed, device)
    out["change"] = program_change(params, start)
    return out


def control(cell: str, config: dict, traffic: dict, *, seed: int, device,
            root, kind: str) -> dict:
    """The control (the reference with float8 products in the port's
    place) or the half-batch fault planted in the reference, against the
    reference: no window."""
    tokens = inputs.make_tokens(traffic, config, seed, device)
    want = reference_readings(config, traffic, tokens, seed, device)
    gc.collect()
    torch.cuda.empty_cache() if torch.device(device).type == "cuda" else None
    got = reference_readings(config, traffic, tokens, seed, device,
                             fp8=kind == "fp8",
                             half_batch=kind == "half_batch")
    gaps = check.training_gaps(got, want)
    ok, checks = check.judge(gaps, check.load_limits(root, cell))
    return {"correct": ok, "checks": checks, "gaps": gaps}


def run(cell: str, config: dict, traffic: dict, *, seed: int, seconds: float,
        trace: bool, device, root, t_start: float,
        fault: str | None = None) -> RunRecord:
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
    b, s = traffic["batch"], traffic["seq"]
    hp_ref = reference.hyperparams(config, b * s)
    tokens = inputs.make_tokens(traffic, config, seed, dev)
    n_slices = tokens.shape[0]
    part("traffic")
    cfg = port_config(config)
    step, init = port_step(cfg, config, traffic)
    params = inputs.make_weights(config, seed, dev)
    state = init(params)
    if fault is not None:
        step = _broken(step, fault, cfg)
    part("weights_and_state")

    def batch(i):
        return {"tokens": tokens[i % n_slices], "prefix": None}

    losses, first = [], {}
    for i in range(PROBE_STEPS):
        params, state, aux = step(params, state, batch(i))
        losses.append(aux["loss"])
        if i == 0:
            first["grad"] = program_grads(state, hp_ref)
    start = inputs.make_weights(config, seed, dev)
    first["change"] = program_change(params, start)
    del start
    first["losses"] = [float(x) for x in losses]
    part("first_steps")
    for i in range(PROBE_STEPS, PROBE_STEPS + WARM_STEPS):
        params, state, _ = step(params, state, batch(i))
    if cuda:
        torch.cuda.synchronize()
    part("warm_up")
    setup_s = time.perf_counter() - t_start

    stretch = Stretch() if trace and cuda else None
    window_losses, stretch_tokens = [], []
    i = PROBE_STEPS + WARM_STEPS
    steps = stretch_steps = 0
    t0 = time.perf_counter()
    while True:
        if (stretch is not None and not stretch.done and not stretch.active
                and time.perf_counter() - t0 >= TRACE_AFTER_S):
            stretch.begin()
        if stretch is not None:
            stretch.span("step")
        feed = batch(i)
        params, state, aux = step(params, state, feed)
        window_losses.append(aux["loss"])
        i += 1
        steps += 1
        if stretch is not None and stretch.active:
            stretch_tokens.append(feed["tokens"])
            stretch_steps += 1
            if stretch_steps >= traffic["trace_steps"]:
                stretch.end(stretch_steps)
            else:
                stretch.close_span()
        if time.perf_counter() - t0 >= seconds and not (
                stretch is not None and stretch.active):
            break
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    finite = int(torch.isfinite(torch.stack(window_losses)).sum())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    record = RunRecord(
        family="lm", setup_s=setup_s, window_s=window_s, steps=steps,
        failed=steps - finite, peak_bytes=peak,
        e2e={"train_tokens_per_s": steps * b * s / window_s,
             "peak_mem_gib": peak / 2**30, "setup_s": setup_s},
        stretch=stretch, notes={"setup_parts_s": parts})
    if stretch is not None and stretch.done:
        record.work = {
            "touched": [int(torch.unique(t).numel()) for t in stretch_tokens],
            "batch": b, "seq": s, "vocab": inputs.padded_vocab(config)}
    del params, state, step, stretch_tokens, window_losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    want = reference_readings(config, traffic, tokens, seed, dev)
    record.gaps = check.training_gaps(first, want)
    record.correct, record.checks = check.judge(
        record.gaps, check.load_limits(root, cell))
    record.notes["reference_s"] = time.perf_counter() - t_ref
    return record
