"""The whole step's share of the card's float32 peak in the traced stretch
of a CTR cell, %: the model's FLOPs a row from the configuration's shapes
(the deep tower's products and the FM term, forward and backward), times
the rows of the stretch, over its wall time and the peak of the precision
the configuration states."""

from portbench import roofline


def read(record, config, traffic):
    s = record.stretch
    flops = roofline.ctr_model_flops(
        len(config["vocab_sizes"]), config["emb_dim"], config["n_dense"],
        config["mlp_dims"]) * traffic["batch"] * s.steps
    peak = roofline.PEAK_FLOPS_PER_S[config["compute_dtype"]]
    return 100.0 * flops / s.wall_s / peak
