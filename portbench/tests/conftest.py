"""The marker of the benchmark's tests that need the card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; the test skips itself when "
        "torch.cuda.is_available() is false")
