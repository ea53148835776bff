"""Fixtures of the benchmark's own tests. Whether a card is present is
decided inside the ``card`` fixture, never at import."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    from repro_torch.core.engine.driver import resolve_device
    return resolve_device("cuda")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's own threads on top of them only contend."""
    import torch
    keep = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(keep)
