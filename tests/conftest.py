import os

# Tests must see the plain 1-device CPU backend (the dry-run, and ONLY the
# dry-run, simulates 512 devices — in its own subprocess).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips itself without one")
