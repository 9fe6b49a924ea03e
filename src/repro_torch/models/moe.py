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
step's arithmetic. The reference's ``constrain`` sharding hints have no
meaning on one card and are dropped.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
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


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig,
            act: str = "swiglu"):
    """x: [B, S, D] -> ([B, S, D], aux_loss f32). Groups = batch rows.

    Token-choice top-k with per-group expert capacity; overflow tokens are
    dropped (Switch/GShard behaviour — the residual carries them)."""
    g, tg, d = x.shape
    dtype = x.dtype
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(tg, cfg)
    tk = tg * k
    dev = x.device

    logits = (x @ params["router"].to(dtype)).to(F32)               # [G,T,E]
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

    # --- batched expert FFN ----------------------------------------------
    h = torch.einsum("gecd,edf->gecf", xe, params["w_in"].to(dtype))
    if act == "swiglu":
        gate = torch.einsum("gecd,edf->gecf", xe, params["w_gate"].to(dtype))
        h = F.silu(gate) * h
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h, approximate="tanh")
    ye = torch.einsum("gecf,efd->gecd", h, params["w_out"].to(dtype))

    # --- gather back + combine -------------------------------------------
    ye_pad = torch.cat([ye, torch.zeros((g, e, 1, d), dtype=ye.dtype,
                                        device=dev)], dim=2)
    got = ye_pad[torch.arange(g, device=dev)[:, None], flat_e, safe_pos]
    weight = (top_p.reshape(g, tk) * keep.to(F32)).to(dtype)
    y = (got * weight[:, :, None]).reshape(g, tg, k, d).sum(dim=2)

    # --- Switch-style load-balance aux loss -------------------------------
    frac_tokens = (_expert_counts(top_e[..., 0], e).to(F32).mean(dim=0)
                   / tg)
    frac_probs = probs.mean(dim=(0, 1))
    aux = cfg.aux_loss_weight * e * torch.sum(frac_tokens * frac_probs)
    return y, aux
