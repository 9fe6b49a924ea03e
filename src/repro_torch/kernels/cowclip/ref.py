"""Plain PyTorch version of the fused CowClip + coupled-L2 + Adam update.

A port of ``repro.kernels.cowclip.ref.cowclip_adam_reference``: it composes
``core.cowclip.cowclip_table`` with coupled L2 and bias-corrected Adam, in
the reference's op order. Rows absent from the batch (``cnt == 0``) take
one geometric L2 decay step, ``w *= 1 - lr*l2``, with the moments held.
It is the CPU path of ``ops.fused_cowclip_adam`` and the oracle the CUDA
kernel is held to on the card.
"""

from __future__ import annotations

import torch

from ...core.cowclip import cowclip_table
from ...core.optim import decay_factor, f32


def cowclip_adam_reference(
    w, g, cnt, m, v, step, *,
    r=1.0, zeta=1e-5, lr=1e-4, l2=1e-5, b1=0.9, b2=0.999, eps=1e-8,
):
    """Returns new ``(w, m, v)``; the inputs are not modified."""
    w32 = w.to(torch.float32)
    m_in = m.to(torch.float32)
    v_in = v.to(torch.float32)
    g32 = g.to(torch.float32)
    g32 = cowclip_table(g32, w32, cnt, r=r, zeta=zeta)
    g32 = g32 + l2 * w32

    m32 = b1 * m_in + (1.0 - b1) * g32
    v32 = b2 * v_in + (1.0 - b2) * torch.square(g32)
    t = f32(int(step))
    m_hat = m32 / (1.0 - b1 ** t)
    v_hat = v32 / (1.0 - b2 ** t)
    touched = (cnt > 0.0)[:, None]
    w32 = torch.where(touched,
                      w32 - lr * m_hat / (torch.sqrt(v_hat) + eps),
                      w32 * decay_factor(lr, l2))
    m32 = torch.where(touched, m32, m_in)
    v32 = torch.where(touched, v32, v_in)
    return w32.to(w.dtype), m32.to(m.dtype), v32.to(v.dtype)
