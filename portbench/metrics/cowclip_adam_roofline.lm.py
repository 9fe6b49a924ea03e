"""The fused CowClip + coupled-L2 + Adam update's share of its roofline on
the token table of an LM cell, %: ``roofline.fused_update`` of the table
at each step's distinct tokens over the device time of the update's
kernels a step."""

from portbench import roofline
from portbench.metrics_common import FUSED, per_step


def read(record, config, traffic):
    t = per_step(record, FUSED)
    if not t:
        return None
    work = record.work
    counts = [roofline.fused_update(work["vocab"], n, config["d_model"])
              for n in work["touched"]]
    nbytes = sum(b for b, _ in counts) / len(counts)
    flops = sum(f for _, f in counts) / len(counts)
    return roofline.share(roofline.bound_s(nbytes, flops)[0], t)
