"""The fused CowClip + coupled-L2 + Adam update's share of its roofline in
a CTR cell, %: the least time of a step's updates of every table (from
each step's touched rows, ``roofline.fused_update``) over the device time
of the update's kernels a step. Nothing where the update does not run."""

from portbench import roofline
from portbench.metrics_common import FUSED, ctr_tables, per_step


def read(record, config, traffic):
    t = per_step(record, FUSED)
    if not t:
        return None
    work = [roofline.fused_update(v, n, d)
            for step in record.work["touched"]
            for v, n, d in ctr_tables(record.work, step)]
    steps = len(record.work["touched"])
    nbytes = sum(b for b, _ in work) / steps
    flops = sum(f for _, f in work) / steps
    return roofline.share(roofline.bound_s(nbytes, flops)[0], t)
