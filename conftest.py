"""Root pytest settings for the whole checkout: registers the ``cuda``
marker of the tests that need an NVIDIA GPU.  Such a test decides inside
a fixture whether a card is present and skips without one; run them on a
machine with a card with ``python -m pytest tests/test_torch_*.py -m cuda``.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with nvcc (skips without one)")
