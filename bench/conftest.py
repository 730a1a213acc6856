"""The ``cuda`` marker, as the repository's tests register it, for a run of
``bench/`` alone."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and the CUDA toolkit (skips, with its reason, elsewhere)",
    )
