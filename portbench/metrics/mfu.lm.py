"""The whole step's share of the card's bf16 peak in the traced stretch of
an LM cell, %: the model's FLOPs a step from the configuration's shapes
(``roofline.lm_step_flops``: 6 per non-embedding parameter and token, and
the scan's), times the stretch's steps, over its wall time and the peak
of the precision the configuration computes in."""

from portbench import roofline


def read(record, config, traffic):
    s = record.stretch
    flops = roofline.lm_step_flops(config, traffic["batch"],
                                   traffic["seq"]) * s.steps
    peak = roofline.PEAK_FLOPS_PER_S[config["compute_dtype"]]
    return 100.0 * flops / s.wall_s / peak
