"""Mixture-of-Experts FFN: token-choice top-k router and sort-based
dispatch, as in ``repro.models.moe``.

Groups are batch rows (a decode step is B groups of one token). Within a
group the k choices of every token are laid out token-major, stably
sorted by expert, and each one's rank within its expert (from the
exclusive cumsum of the per-expert counts) is checked against the
capacity; overflow choices are dropped (the residual carries them).
Dispatch is a gather, slot ``(e, c)`` taking the choice at
``order[starts[e] + c]``; the experts run as batched einsums; the combine
gathers each choice's output back from ``ye`` padded by one overflow slot.

Nothing here reads a value on the host or scatters a float: the expert
counts are an integer ``scatter_add_`` into a ``[G, E]`` tensor (exact on
the card), so a decode step captures as a CUDA graph and replays the eager
step's arithmetic. The reference's two-stage reshard of the dispatched
and the expert outputs is kept (``sharding.act.constrain``, a no-op off a
mesh).

Everything on the values' path is differentiable, as in the reference:
the router's softmax and top-k values, the gathers and the einsums (the
expert ids, orders and counts are integers and carry no gradient); the
aux loss's gradient reaches the router through ``probs``. The gradient of
a gather is an accumulating scatter: on the CPU it sums in a fixed order,
so the backward repeats bit for bit there; on the card the dispatch
gather's backward (``take_along_dim``: a ``scatter_add`` where the rows
of a token sent to several experts collide) adds with atomics, so the
MoE backward is not bitwise repeatable on the card.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..sharding.act import constrain, local_region
from .layers import _normal

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


def init_moe(gen, d_model: int, d_ff: int, cfg: MoEConfig,
             act: str = "swiglu", *, lead: tuple = (), device="cuda") -> dict:
    """``lead`` prepends stacking dims (``[n_repeats]`` in ``lm.init``)."""
    device = resolve_device(device)
    e = cfg.n_experts
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    p = {
        "router": _normal(gen, lead + (d_model, e), s_in, device),
        "w_in": _normal(gen, lead + (e, d_model, d_ff), s_in, device),
        "w_out": _normal(gen, lead + (e, d_ff, d_model), s_out, device),
    }
    if act == "swiglu":
        p["w_gate"] = _normal(gen, lead + (e, d_model, d_ff), s_in, device)
    return p


def capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(c, cfg.top_k)


def _expert_counts(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """[G, T] expert ids -> [G, E] int64 counts (``bincount`` per group,
    without its read of the maximum on the host)."""
    counts = torch.zeros((ids.shape[0], n_experts), dtype=torch.int64,
                         device=ids.device)
    return counts.scatter_add_(1, ids, torch.ones_like(ids))


def _route(x, router, e: int, k: int, cap: int):
    """Routing and dispatch, group by group: ``(probs [G,T,E], top_p,
    top_e [G,T,k], flat_e, keep, safe_pos [G,Tk], xe [G,E,C,D])``."""
    g, tg, d = x.shape
    dtype = x.dtype
    tk = tg * k
    dev = x.device

    logits = (x @ router.to(dtype)).to(F32)                         # [G,T,E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)                     # [G,T,k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # --- sort-based position-in-expert (group-local) ---------------------
    flat_e = top_e.reshape(g, tk)                                   # [G,Tk]
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.take_along_dim(flat_e, order, dim=1)
    counts = _expert_counts(flat_e, e)                              # [G,E]
    starts = torch.cumsum(counts, dim=1) - counts                   # exclusive
    rank_sorted = (torch.arange(tk, device=dev)[None, :]
                   - torch.take_along_dim(starts, sorted_e, dim=1))
    inv_order = torch.argsort(order, dim=1)                         # unsort
    pos = torch.take_along_dim(rank_sorted, inv_order, dim=1)       # [G,Tk]

    keep = pos < cap
    safe_pos = torch.where(keep, pos, cap)                          # overflow slot

    # --- dispatch as a gather: slot (e, c) pulls choice order[starts+c] --
    slots = torch.arange(cap, device=dev)
    slot_src = starts[:, :, None] + slots[None, None, :]            # [G,E,C]
    slot_valid = slots[None, None, :] < torch.clamp(counts, max=cap)[:, :, None]
    slot_src = torch.clamp(slot_src, 0, tk - 1).reshape(g, e * cap)
    src_choice = torch.take_along_dim(order, slot_src, dim=1)       # [G,E*C]
    # choice i is token i // k's: the reference's gather from x repeated
    # k times, without the [G, T*k, D] copy
    xe = torch.take_along_dim(x, (src_choice // k)[:, :, None], dim=1)
    xe = xe.reshape(g, e, cap, d) * slot_valid[..., None].to(dtype)
    return probs, top_p, top_e, flat_e, keep, safe_pos, xe


def _experts(xe, w_in, w_gate, w_out, act: str):
    """The batched expert FFN: ``[G,E,C,D] -> [G,E,C,D]``."""
    dtype = xe.dtype
    h = torch.einsum("gecd,edf->gecf", xe, w_in.to(dtype))
    if act == "swiglu":
        gate = torch.einsum("gecd,edf->gecf", xe, w_gate.to(dtype))
        h = F.silu(gate) * h
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("gecf,efd->gecd", h, w_out.to(dtype))


def _combine(ye, flat_e, safe_pos, top_p, keep):
    """Each choice's expert output gathered back from ``ye`` padded by one
    overflow slot, weighted and summed per token: ``[G,T,D]``."""
    g, e, _, d = ye.shape
    tk = flat_e.shape[1]
    k = top_p.shape[-1]
    dtype = ye.dtype
    ye_pad = torch.cat([ye, torch.zeros((g, e, 1, d), dtype=ye.dtype,
                                        device=ye.device)], dim=2)
    got = ye_pad[torch.arange(g, device=ye.device)[:, None], flat_e,
                 safe_pos]
    weight = (top_p.reshape(g, tk) * keep.to(F32)).to(dtype)
    return (got * weight[:, :, None]).reshape(g, tk // k, k, d).sum(dim=2)


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig,
            act: str = "swiglu"):
    """x: [B, S, D] -> ([B, S, D], aux_loss f32). Groups = batch rows.

    Token-choice top-k with per-group expert capacity; overflow tokens are
    dropped (Switch/GShard behaviour — the residual carries them). On a
    mesh (the dry-run) routing, dispatch and combine run on each rank's
    groups and the experts on each rank's groups and experts
    (``sharding.act.local_region``)."""
    g, tg, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(tg, cfg)
    tk = tg * k
    rows = ("batch", None, None)

    probs, top_p, top_e, flat_e, keep, safe_pos, xe = local_region(
        lambda x, router: _route(x, router, e, k, cap), (rows, (None, None)),
        [((g, tg, e), rows), ((g, tg, k), rows), ((g, tg, k), rows),
         ((g, tk), ("batch", None)), ((g, tk), ("batch", None)),
         ((g, tk), ("batch", None)), ((g, e, cap, d), rows + (None,))],
    )(x, params["router"])
    # two-stage reshard: the gather local to each data shard (E
    # replicated), then E sliced onto the model axis
    xe = constrain(xe, "batch", None, None, None)
    xe = constrain(xe, "batch", "model", None, None)

    experts = ("batch", "model", None, None)
    w_gate = params.get("w_gate", params["w_in"])
    ye = local_region(
        lambda xe, w_in, w_gate, w_out: _experts(xe, w_in, w_gate, w_out,
                                                 act),
        (experts, ("model", None, None), ("model", None, None),
         ("model", None, None)),
        (tuple(xe.shape), experts),
    )(xe, params["w_in"], w_gate, params["w_out"])
    ye = constrain(ye, "batch", "model", None, None)
    ye = constrain(ye, "batch", None, None, None)   # all-gather E (the comm)

    y = local_region(
        _combine,
        (rows + (None,), ("batch", None), ("batch", None), rows,
         ("batch", None)),
        ((g, tg, d), rows),
    )(ye, flat_e, safe_pos, top_p, keep)

    # --- Switch-style load-balance aux loss -------------------------------
    counts = local_region(lambda t: _expert_counts(t, e), (("batch", None),),
                          ((g, e), ("batch", None)))(top_e[..., 0])
    frac_tokens = counts.to(F32).mean(dim=0) / tg
    frac_probs = probs.mean(dim=(0, 1))
    aux = cfg.aux_loss_weight * e * torch.sum(frac_tokens * frac_probs)
    return y, aux
