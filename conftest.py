"""Repository-wide pytest settings: the marker of tests that need the card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (an NVIDIA H100 for the sm_90a kernels); "
        "skips where there is none")
