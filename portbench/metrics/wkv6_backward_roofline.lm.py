"""The WKV6 backward kernel's share of its roofline in an LM cell, %: a
step's layers of ``roofline.wkv6_backward`` at the cell's shapes (float32)
over the device time of the backward kernel a step."""

from portbench import roofline
from portbench.metrics_common import WKV6_BACKWARD, per_step


def read(record, config, traffic):
    t = per_step(record, WKV6_BACKWARD)
    if not t:
        return None
    bh = traffic["batch"] * config["n_heads"]
    n = config["d_model"] // config["n_heads"]
    nbytes, flops = roofline.wkv6_backward(bh, traffic["seq"], n)
    layers = config["n_layers"]
    return roofline.share(layers * roofline.bound_s(nbytes, flops)[0], t)
