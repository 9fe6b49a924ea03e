"""The plain reference of a CTR cell: DeepFM's forward, its gradient, and
the paper's two-group update, in plain PyTorch.

Written from the paper (arXiv:2204.06240) and the configuration file, not
from the port: it imports nothing of ``repro_torch`` or of the JAX package
and reads nothing the port made. Every table is updated dense, the whole
table a step, which is what the port's fused placement computes and what
its sparse placement computes once its pending decay is flushed.

One step ``t`` (1-based) on a batch of ids, dense features and labels:

* logits: the first-order sum, the FM pairwise term and the deep tower
  (ReLU between layers and after the last, then one linear output);
  loss: mean binary cross-entropy from logits;
* each table's gradient ``g`` by autograd through its gather;
* CowClip on each row of a table of width 2 or more: ``g *= min(1, cnt *
  max(r ||w||, zeta) / ||g||)``, ``cnt`` the id's count in the batch;
* coupled L2: ``g += l2 w``; Adam with bias correction on the rows the
  batch touches; an untouched row takes only ``w *= 1 - lr l2``, its
  moments held;
* the dense tower: Adam, its learning rate warmed up linearly over
  ``warmup_steps``, no L2.

Computed in float32 with TF32 off, as the configuration states; ``tf32``
computes the products in TF32 instead (the control). ``half_batch`` drops
the second half of each batch (a fault).
"""

from __future__ import annotations

import contextlib
import math

import torch


def hyperparams(config: dict, batch: int) -> dict:
    """The CowClip scaling rule (paper, Rule 3) from the base batch:
    the embedding lr fixed, its L2 times s, the dense lr times sqrt(s)."""
    h = config["hyperparams"]
    s = batch / h["base_batch"]
    return {"emb_lr": h["base_lr"], "emb_l2": h["base_l2"] * s,
            "dense_lr": h["base_dense_lr"] * math.sqrt(s),
            "warmup_steps": max(1, h["epoch_rows"] // batch),
            "r": h["r"], "zeta": h["zeta"], "b1": h["b1"], "b2": h["b2"],
            "eps": h["eps"]}


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa (nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _mm(a, b, tf32: bool):
    if tf32 and a.device.type != "cuda":
        # the CPU has no TF32 products: round the operands as the tensor
        # cores do, passing the gradient straight through
        a = a + (_round_tf32(a.detach()) - a).detach()
        b = b + (_round_tf32(b.detach()) - b).detach()
    return a @ b


@contextlib.contextmanager
def _precision(tf32: bool, device):
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    on = bool(tf32 and torch.device(device).type == "cuda")
    matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def logits(params: dict, ids, dense, config: dict, tf32: bool = False):
    """DeepFM's logits [B] from the port-layout tree of tables and tower."""
    n_fields = len(config["vocab_sizes"])
    fm = params["embed"]["fm"]
    lin = params["embed"]["lin"]
    idx = ids.long()
    emb = torch.stack([fm[f"field_{f}"][idx[:, f]] for f in range(n_fields)],
                      dim=1)                                   # [B, F, D]
    first = torch.stack([lin[f"field_{f}"][idx[:, f], 0]
                         for f in range(n_fields)], dim=1).sum(1)
    d = params["dense"]
    x = torch.cat([emb.reshape(emb.shape[0], -1), dense], dim=-1)
    n_mlp = len(config["mlp_dims"])
    for i in range(n_mlp):
        x = torch.relu(_mm(x, d["mlp"][f"w{i}"], tf32) + d["mlp"][f"b{i}"])
    deep = (_mm(x, d["deep_out"]["w0"], tf32) + d["deep_out"]["b0"])[:, 0]
    s = emb.sum(dim=1)
    pair = 0.5 * (s * s - (emb * emb).sum(dim=1)).sum(dim=-1)
    return first + d["lin_bias"] + pair + deep


def loss(z, labels):
    return torch.mean(torch.logaddexp(z, torch.zeros_like(z)) - labels * z)


def leaves(tree: dict, prefix: str = "") -> dict:
    """``{"a.b.c": tensor}`` of a tree of dicts."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(leaves(v, name + "."))
        else:
            out[name] = v
    return out


def run_steps(params: dict, batches: list, config: dict, hp: dict, *,
              tf32: bool = False, half_batch: bool = False) -> dict:
    """``len(batches)`` steps from ``params`` (updated in place). Returns
    ``{"losses": [...], "grad": {leaf: norm of the first step's gradient
    as the optimizer takes it}, "change": {leaf: norm of the change over
    all the steps}}``; the embedding tables' gradient as their optimizer
    takes it is CowClip's plus the coupled L2 on the touched rows."""
    named = leaves(params)
    start = {k: v.clone() for k, v in named.items()}
    embed = {k: v for k, v in named.items() if k.startswith("embed.")}
    dense = {k: v for k, v in named.items() if k.startswith("dense.")}
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v))
               for k, v in named.items()}
    b1, b2, eps = hp["b1"], hp["b2"], hp["eps"]
    lr, l2 = hp["emb_lr"], hp["emb_l2"]
    decay = 1.0 - lr * l2
    out = {"losses": [], "grad": {}, "change": {}}
    device = next(iter(named.values())).device
    for t, batch in enumerate(batches, start=1):
        ids, feats, labels = batch["ids"], batch["dense"], batch["labels"]
        if half_batch:
            half = ids.shape[0] // 2
            ids, feats, labels = ids[:half], feats[:half], labels[:half]
        for v in named.values():
            v.requires_grad_(True)
        with torch.enable_grad(), _precision(tf32, device):
            value = loss(logits(params, ids, feats, config, tf32), labels)
            grads = torch.autograd.grad(value, list(named.values()))
        for v in named.values():
            v.requires_grad_(False)
        out["losses"].append(float(value.detach()))
        grads = dict(zip(named, grads))
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        with torch.no_grad():
            for name, w in embed.items():
                f = int(name.rsplit("_", 1)[1])
                g = grads[name]
                cnt = torch.bincount(ids[:, f].long(),
                                     minlength=w.shape[0]).to(torch.float32)
                if w.shape[1] >= 2:
                    gn = g.norm(dim=1)
                    clip_t = cnt * torch.clamp_min(hp["r"] * w.norm(dim=1),
                                                   hp["zeta"])
                    g = g * torch.clamp_max(clip_t / (gn + 1e-30), 1.0)[:, None]
                g = g + l2 * w
                touched = (cnt > 0)[:, None]
                g = torch.where(touched, g, torch.zeros_like(g))
                if t == 1:
                    out["grad"][name] = float(g.double().norm())
                m, v = moments[name]
                m_new = b1 * m + (1.0 - b1) * g
                v_new = b2 * v + (1.0 - b2) * g * g
                step = lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
                w.copy_(torch.where(touched, w - step, w * decay))
                m.copy_(torch.where(touched, m_new, m))
                v.copy_(torch.where(touched, v_new, v))
                del g, cnt, step, m_new, v_new
            dense_lr = hp["dense_lr"] * min(t / hp["warmup_steps"], 1.0)
            for name, w in dense.items():
                g = grads[name]
                if t == 1:
                    out["grad"][name] = float(g.double().norm())
                m, v = moments[name]
                m.mul_(b1).add_((1.0 - b1) * g)
                v.mul_(b2).add_((1.0 - b2) * g * g)
                w.sub_(dense_lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
        del grads
    for name, w in named.items():
        out["change"][name] = float((w.double() - start[name].double()).norm())
    return out
