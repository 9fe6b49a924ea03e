def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips itself without one")
