"""The Mamba-2 (SSD) selective scan: CUDA kernels, plain versions, the op."""
from .ops import ssd_scan, ssd_scan_bwd, ssd_scan_fwd
from .ref import (CHUNK, n_chunks, ssd_scan_backward_chunked_reference,
                  ssd_scan_backward_reference,
                  ssd_scan_chunked_reference, ssd_scan_reference)
