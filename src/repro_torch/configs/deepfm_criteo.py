"""deepfm-criteo — the paper's own experimental config (DeepFM on Criteo).

A copy of ``repro.configs.deepfm_criteo``: 26 categorical fields, 13
continuous; emb dim 10, MLP 3x400 (paper 'Implementation details'). The
vocab sizes are the common hashed layout after standard filtering: 33.76M
ids in all, 10.13M in the largest field.
"""

from ..models.ctr import CTRConfig

CRITEO_VOCABS = (
    1461, 584, 10131227, 2202608, 306, 24, 12518, 634, 4, 93146,
    5684, 8351593, 3195, 28, 14993, 5461306, 11, 5653, 2173, 4,
    7046547, 18, 16, 286181, 105, 142572,
)

CONFIG = CTRConfig(
    name="deepfm",
    vocab_sizes=CRITEO_VOCABS,
    n_dense=13,
    emb_dim=10,
    mlp_dims=(400, 400, 400),
)
