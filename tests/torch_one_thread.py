"""The port's test modules import :func:`one_torch_thread` (an autouse
fixture) to run on one torch intra-op thread: the plain versions run many
small ops, which many threads on cores the other test workers share slow
down (the genome example took 24 s on 8 threads under six workers, 4 s
on one)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
