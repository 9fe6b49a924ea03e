"""Build the port's CUDA kernels: one extension, compiled at first use.

The five kernels (``cowclip/csrc/cowclip_adam.cu``, ``sparse_catchup.cu``
and ``sparse_update.cu``; ``wkv6/csrc/wkv6.cu``;
``embedding/csrc/embedding_backward.cu``) are compiled for
``sm_90a`` into one extension by ``torch.utils.cpp_extension.load``, from
the sources in this package, into ``build/repro_torch_kernels/`` at the
root of the checkout (listed in ``.gitignore``), at first use and never at
import. ``csrc/binding.cpp`` is the only file that includes
``torch/extension.h``: each kernel has a plain C interface (its header), so
nvcc compiles the kernels in seconds and the host compiler the binding.
No fast-math flag: the wkv6 kernel needs subnormal floats
(``wkv6/csrc/wkv6.cu``, "Numerics").
"""

from __future__ import annotations

import functools
from pathlib import Path

KERNELS = Path(__file__).resolve().parent
SOURCES = ("csrc/binding.cpp", "cowclip/csrc/cowclip_adam.cu",
           "cowclip/csrc/sparse_catchup.cu", "cowclip/csrc/sparse_update.cu",
           "wkv6/csrc/wkv6.cu", "embedding/csrc/embedding_backward.cu")
INCLUDE_DIRS = ("cowclip/csrc", "wkv6/csrc", "embedding/csrc")
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
