"""The sparse update's (catch-up and update kernels together) share of its
roofline in a CTR cell, %: the least time of a step's sparse updates of
every table (``roofline.sparse_pair``, from each step's touched rows) over
the device time of the pair's kernels a step. Nothing where the pair does
not run."""

from portbench import roofline
from portbench.metrics_common import SPARSE, ctr_tables, per_step


def read(record, config, traffic):
    t = per_step(record, SPARSE)
    if not t:
        return None
    work = [roofline.sparse_pair(n, d)
            for step in record.work["touched"]
            for _, n, d in ctr_tables(record.work, step)]
    steps = len(record.work["touched"])
    nbytes = sum(b for b, _ in work) / steps
    flops = sum(f for _, f in work) / steps
    return roofline.share(roofline.bound_s(nbytes, flops)[0], t)
