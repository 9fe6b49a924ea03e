"""The WKV6 scan's forward kernels' share of their roofline in an LM cell,
%: a step's layers of ``roofline.wkv6_forward`` at the cell's shapes
(float32, as the scan computes) over the device time of the forward's
kernels a step."""

from portbench import roofline
from portbench.metrics_common import WKV6_FORWARD, per_step


def read(record, config, traffic):
    t = per_step(record, WKV6_FORWARD)
    if not t:
        return None
    bh = traffic["batch"] * config["n_heads"]
    n = config["d_model"] // config["n_heads"]
    nbytes, flops = roofline.wkv6_forward(bh, traffic["seq"], n)
    layers = config["n_layers"]
    return roofline.share(layers * roofline.bound_s(nbytes, flops)[0], t)
