"""The plain reference of an RWKV-6 LM training cell: the model's forward,
its next-token loss and gradient, and the paper's two-group update with
CowClip on the token table, in plain PyTorch and float32.

Written from RWKV-6 "Finch" (arXiv:2404.05892) as the port's model states
it, not from the port's code: it imports nothing of ``repro_torch`` or of
the JAX package and reads nothing the port made. The port's model departs
from the paper in three ways, which the reference follows: the token shift
mixes r, k, v and g with static weights (the paper's data-dependent
``ddlerp`` only for the decay, through its low-rank ``wA``/``wB``), the
wkv output is normalised per head by an RMS norm (the paper: a group
norm), and the blocks' norms are RMS norms.

A layer, for ``x`` [B, S, D] and its shift ``x'`` (zeros first):

    lerp(m) = x + (x' - x) m;  r, k, v, g = lerp(m_*) W_*
    w = exp(-exp(w0 + tanh(lerp(m_w) wA) wB))              (decay in (0, 1))
    S_t = diag(w_t) S_{t-1} + k_t v_t^T;  y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    out = (rms_head(y) * ln_scale * silu(g)) W_o
    x += out(rms(x));  h = rms(x);  x += sigmoid(lerp_h(m_r) W_r) * (relu(lerp_h(m_k) W_k)^2 W_v)

then ``rms(x) @ head``, the mean cross-entropy of each position's next
token. The scan runs chunk by chunk in the exact factorisation (decays
between two tokens of a chunk as differences of cumulative log-decays,
never a ratio that can overflow), and each layer is recomputed in the
backward (``torch.utils.checkpoint``) so that eight layers at full width
fit beside the optimizer's state.

``fp8`` holds what the configuration computes in bfloat16 in float8 e4m3
instead (a scale a tensor): every product's operands and result, the
token rows and the norms' outputs, the scan and the norms themselves in
float32 as in the port. It is the control; ``half_batch`` drops the
second half of each batch, a fault.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .ctr import leaves

CHUNK = 16
E4M3_MAX = 448.0


def hyperparams(config: dict, tokens_per_step: int) -> dict:
    """The CowClip scaling rule from the base batch (``tokens_per_step``
    the batch in tokens): embedding lr fixed, its L2 times s, the dense lr
    times sqrt(s); the dense warm-up of ``warmup_steps``."""
    h = config["hyperparams"]
    s = tokens_per_step / h["base_batch"]
    return {"emb_lr": h["base_lr"], "emb_l2": h["base_l2"] * s,
            "dense_lr": h["base_dense_lr"] * math.sqrt(s),
            "warmup_steps": h["warmup_steps"], "r": h["r"],
            "zeta": h["zeta"], "b1": h["b1"], "b2": h["b2"], "eps": h["eps"]}


def _round_fp8(x):
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def _q(x, fp8: bool):
    """An activation as the control holds it: float8 e4m3, else as is."""
    return _round_fp8(x) if fp8 else x


def _mm(a, b, fp8: bool):
    if fp8:
        return _round_fp8(_round_fp8(a) @ _round_fp8(b))
    return a @ b


def _rms(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def _shift(x):
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def wkv(r, k, v, w, u):
    """The recurrence over [B, S, H, N] streams and [H, N] bonus u, chunk
    by chunk: y [B, S, H, N]."""
    b, s, h, n = r.shape
    pad = -s % CHUNK
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    c = (s + pad) // CHUNK
    # [B, H, C, L, N]
    r, k, v, w = (t.reshape(b, c, CHUNK, h, n).permute(0, 3, 1, 2, 4)
                  for t in (r, k, v, w))
    logw = torch.log(w)
    cum = torch.cumsum(logw, dim=3)                 # c_t, through token t
    before = cum - logw                             # c_{t-1}
    # decay from token s (after it) to token t (before it), s < t
    diff = before[..., :, None, :] - cum[..., None, :, :]   # [.., t, s, N]
    mask = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool,
                                 device=r.device), -1)
    decay = torch.where(mask[..., None], torch.exp(torch.clamp_max(diff, 0)),
                        torch.zeros((), device=r.device))
    att = torch.einsum("bhctn,bhcsn,bhctsn->bhcts", r, k, decay)
    bonus = torch.einsum("bhctn,hn,bhctn->bhct", r, u, k)
    y_in = torch.einsum("bhcts,bhcsn->bhctn", att, v) + bonus[..., None] * v
    r_dec = r * torch.exp(before)                   # r_t decayed to the start
    k_dec = k * torch.exp(cum[..., -1:, :] - cum)   # k_s decayed to the end
    w_all = torch.exp(cum[..., -1, :])              # [B, H, C, N]
    state = torch.zeros(b, h, n, n, device=r.device, dtype=r.dtype)
    ys = []
    for i in range(c):
        ys.append(torch.einsum("bhtn,bhnm->bhtm", r_dec[:, :, i], state))
        state = w_all[:, :, i, :, None] * state + torch.einsum(
            "bhsn,bhsm->bhnm", k_dec[:, :, i], v[:, :, i])
    y = y_in + torch.stack(ys, dim=2)
    return y.permute(0, 2, 3, 1, 4).reshape(b, s + pad, h, n)[:, :s]


def _layer(x, p: dict, n_heads: int, eps: float, fp8: bool):
    b, s, d = x.shape
    n = d // n_heads
    a = p["att"]
    xn = _q(_rms(x, p["norm1"]["scale"], eps), fp8)
    xs = _shift(xn)

    def lerp(src, shifted, mix):
        return src + (shifted - src) * mix

    r = _mm(lerp(xn, xs, a["mix_r"]), a["wr"], fp8)
    k = _mm(lerp(xn, xs, a["mix_k"]), a["wk"], fp8)
    v = _mm(lerp(xn, xs, a["mix_v"]), a["wv"], fp8)
    g = _mm(lerp(xn, xs, a["mix_g"]), a["wg"], fp8)
    wlog = a["w0"] + _mm(torch.tanh(_mm(lerp(xn, xs, a["mix_w"]), a["wA"],
                                        fp8)), a["wB"], fp8)
    w = torch.exp(-torch.exp(wlog))
    heads = (b, s, n_heads, n)
    y = wkv(r.view(heads), k.view(heads), v.view(heads), w.view(heads),
            a["u"].view(n_heads, n))
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-5)
    y = (y * a["ln_scale"]).reshape(b, s, d)
    x = x + _mm(y * F.silu(g), a["wo"], fp8)
    f = p["ffn"]
    h = _q(_rms(x, p["norm2"]["scale"], eps), fp8)
    hs = _shift(h)
    kk = torch.square(torch.relu(_mm(lerp(h, hs, f["mix_k"]), f["wk"], fp8)))
    rr = torch.sigmoid(_mm(lerp(h, hs, f["mix_r"]), f["wr"], fp8))
    return x + rr * _mm(kk, f["wv"], fp8)


def loss(params: dict, tokens, config: dict, fp8: bool = False):
    """The mean next-token cross-entropy of ``tokens`` [B, S]."""
    eps = config["norm_eps"]
    x = _q(params["embed"]["tokens"][tokens.long()], fp8)
    pos = params["dense"]["blocks"]["pos_0"]
    for i in range(config["n_layers"]):
        layer = {g: {k: t[i] for k, t in part.items()}
                 for g, part in pos.items()}
        x = checkpoint(_layer, x, layer, config["n_heads"], eps, fp8,
                       use_reentrant=False)
    x = _rms(x, params["dense"]["final_norm"]["scale"], eps)
    logits = _mm(x[:, :-1], params["dense"]["head"], fp8)
    logits = logits[..., :config["vocab_size"]]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())


def run_steps(params: dict, batches: list, config: dict, hp: dict, *,
              fp8: bool = False, half_batch: bool = False) -> dict:
    """``len(batches)`` steps from ``params`` (updated in place); the same
    readings as ``reference.ctr.run_steps``, but for the change, which the
    caller takes against the weights drawn again (``start`` would double
    the memory): ``{"losses", "grad"}``."""
    named = leaves(params)
    table = "embed.tokens"
    moments = {}
    b1, b2, eps = hp["b1"], hp["b2"], hp["eps"]
    lr, l2 = hp["emb_lr"], hp["emb_l2"]
    out = {"losses": [], "grad": {}}
    for t, tokens in enumerate(batches, start=1):
        if half_batch:
            tokens = tokens[:tokens.shape[0] // 2]
        for v in named.values():
            v.requires_grad_(True)
        with torch.enable_grad():
            value = loss(params, tokens, config, fp8)
            grads = dict(zip(named, torch.autograd.grad(
                value, list(named.values()))))
        for v in named.values():
            v.requires_grad_(False)
        out["losses"].append(float(value.detach()))
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        with torch.no_grad():
            w = named[table]
            g = grads.pop(table)
            cnt = torch.bincount(tokens.reshape(-1).long(),
                                 minlength=w.shape[0]).to(torch.float32)
            clip_t = cnt * torch.clamp_min(hp["r"] * w.norm(dim=1),
                                           hp["zeta"])
            g.mul_(torch.clamp_max(clip_t / (g.norm(dim=1) + 1e-30),
                                   1.0)[:, None])
            g.add_(l2 * w)
            touched = (cnt > 0)[:, None]
            g.mul_(touched)
            if t == 1:
                out["grad"][table] = float(g.double().norm())
            m, v = moments.setdefault(table, (torch.zeros_like(w),
                                              torch.zeros_like(w)))
            m_new = torch.where(touched, b1 * m + (1.0 - b1) * g, m)
            v.copy_(torch.where(touched, b2 * v + (1.0 - b2) * g * g, v))
            m.copy_(m_new)
            del m_new, g
            step = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            w.copy_(torch.where(touched, w - step, w * (1.0 - lr * l2)))
            del step
            dense_lr = hp["dense_lr"] * min(t / hp["warmup_steps"], 1.0)
            for name in list(grads):
                w, g = named[name], grads.pop(name)
                if t == 1:
                    out["grad"][name] = float(g.double().norm())
                m, v = moments.setdefault(name, (torch.zeros_like(w),
                                                 torch.zeros_like(w)))
                m.mul_(b1).add_((1.0 - b1) * g)
                v.mul_(b2).add_((1.0 - b2) * g * g)
                w.sub_(dense_lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
                del g
    return out
