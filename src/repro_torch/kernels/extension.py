"""Build the port's CUDA kernels: one extension, compiled at first use.

The eight kernels (``cowclip/csrc/cowclip_adam.cu``, ``sparse_catchup.cu``
and ``sparse_update.cu``; the chunked WKV6 scan's forward and backward,
``wkv6/csrc/wkv6.cu`` and ``wkv6_backward.cu``;
``embedding/csrc/embedding_backward.cu``; the Mamba-2 scan's forward and
backward, ``ssd/csrc/ssd_scan.cu``) are compiled for
``sm_90a`` into one extension by ``torch.utils.cpp_extension.load``, from
the sources in this package, into ``build/repro_torch_kernels/`` at the
root of the checkout (listed in ``.gitignore``), at first use and never at
import. ``csrc/binding.cpp`` is the only file that includes
``torch/extension.h``: each kernel has a plain C interface (its header), so
nvcc compiles the kernels in seconds and the host compiler the binding.
The scan kernels (wkv6's forward and backward, the Mamba-2 scan's
forward and backward) share ``csrc/mma_tf32.cuh``: 3xTF32 tensor-core products and
``cp.async`` copies.
No fast-math flag: the wkv6 kernels need subnormal floats
(``wkv6/csrc/wkv6.cu``, "Numerics").
"""

from __future__ import annotations

import functools
from pathlib import Path

KERNELS = Path(__file__).resolve().parent
SOURCES = ("csrc/binding.cpp", "cowclip/csrc/cowclip_adam.cu",
           "cowclip/csrc/sparse_catchup.cu", "cowclip/csrc/sparse_update.cu",
           "wkv6/csrc/wkv6.cu", "wkv6/csrc/wkv6_backward.cu",
           "embedding/csrc/embedding_backward.cu", "ssd/csrc/ssd_scan.cu")
INCLUDE_DIRS = ("csrc", "cowclip/csrc", "wkv6/csrc", "embedding/csrc",
                "ssd/csrc")
BUILD_DIR = KERNELS.parents[2] / "build" / "repro_torch_kernels"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]


@functools.cache
def build():
    """Compile (or load the cached build of) the extension; returns it."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)   # load() does not
    return load(
        name="repro_torch_kernels",
        sources=[str(KERNELS / name) for name in SOURCES],
        build_directory=str(BUILD_DIR),
        extra_include_paths=[str(KERNELS / d) for d in INCLUDE_DIRS],
        extra_cuda_cflags=CUDA_FLAGS,
        verbose=False,
    )
