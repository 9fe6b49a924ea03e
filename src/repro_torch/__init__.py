"""repro_torch — the PyTorch / CUDA port of ``repro`` for one NVIDIA H100.

It imports ``torch``, NumPy and the standard library, never ``jax`` or
anything of ``repro``. Entry points run on ``device="cuda"`` unless the
caller passes ``device="cpu"``.
"""
