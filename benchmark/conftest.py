"""pytest settings of the benchmark's own tests (`pytest benchmark/tests`).

`card` marks a test that needs an NVIDIA GPU; such a test decides inside
itself whether one is present, and skips here with the reason."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (skips without one)")
