"""``remat_policy="dots"`` in the port's LM against the JAX package's
``dots_with_no_batch_dims_saveable``, on the CPU: the eight arch cases of
``test_torch_lm_train.py``, held as ``test_torch_remat.py`` holds "full"
(loss 1e-4, every gradient leaf at ``GRAD_BAR`` / ``RWKV6_SCAN_GRAD_BAR``
against JAX, bitwise against the port without remat)."""

import pytest

from test_torch_lm_train import LM_CASES
from test_torch_remat import check_remat_case


@pytest.mark.parametrize("arch,kw,grad_bar", LM_CASES)
def test_torch_remat_dots_matches_jax(arch, kw, grad_bar):
    check_remat_case(arch, kw, grad_bar, "dots")
