import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    """Two threads a test process: the tests run several processes on a
    few cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
