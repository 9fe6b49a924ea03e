"""The embedding backward's share of its roofline in a CTR cell, %: the
least time of a step's gradient of the fm and LR lookups
(``roofline.embedding_backward``: the ids and cotangents read, the touched
rows' gradient written) over the device time the step spends on it: the
backward's level kernels, the fill of its output just before them, and on
the fused placement the sort it makes for itself."""

from portbench import roofline
from portbench.metrics_common import embedding_backward_s


def read(record, config, traffic):
    work = record.work
    own_sort = traffic["placement"] != "sparse"
    t = embedding_backward_s(record, own_sort)
    if not t:
        return None
    n_keys = work["batch"] * len(work["vocabs"])
    steps = work["touched"]
    nbytes = flops = 0
    for step in steps:
        b, f = roofline.embedding_backward(n_keys, (work["emb_dim"], 1),
                                           sum(step))
        nbytes, flops = nbytes + b, flops + f
    return roofline.share(
        roofline.bound_s(nbytes / len(steps), flops / len(steps))[0], t)
