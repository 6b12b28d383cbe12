"""Settings of the benchmark's own tests.  Imports no JAX; registers the
marker of the tests that need a CUDA card, which decide in a fixture, never
at import, whether one is there."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run this test on the chip")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="session")
def one_thread():
    """One intra-op thread a test process, as ``run.main`` sets: several
    workers each running a thread per core slowed a request of the tiny
    cells past their window."""
    import torch

    torch.set_num_threads(1)
