"""The benchmark's tests run tiny graphs, where torch's intra-op threads
only contend with the other test workers: each test runs on one thread and
gives the setting back."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
