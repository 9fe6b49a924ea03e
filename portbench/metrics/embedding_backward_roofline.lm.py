"""The embedding backward's share of its roofline on the token table of an
LM cell, %: ``roofline.embedding_backward`` of a step's tokens (the ids and
the cotangent read, the distinct tokens' rows written) over the device time
the step spends on it: its level kernels, the fill of its output just
before them, and the sort it makes for itself."""

from portbench import roofline
from portbench.metrics_common import embedding_backward_s


def read(record, config, traffic):
    t = embedding_backward_s(record, own_sort=True)
    if not t:
        return None
    work = record.work
    keys = traffic["batch"] * traffic["seq"]
    counts = [roofline.embedding_backward(keys, (config["d_model"],), n)
              for n in work["touched"]]
    nbytes = sum(b for b, _ in counts) / len(counts)
    flops = sum(f for _, f in counts) / len(counts)
    return roofline.share(roofline.bound_s(nbytes, flops)[0], t)
