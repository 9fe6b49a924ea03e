"""repro_torch.data — synthetic Zipf CTR and LM generators and the Criteo
loader (NumPy)."""

from .criteo import load_criteo_tsv
from .synthetic import (CTRDataset, iterate_batches, make_ctr_dataset,
                        make_lm_tokens)
