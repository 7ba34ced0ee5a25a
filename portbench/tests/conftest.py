"""The benchmark's CPU tests run on one torch thread each, so that several
test processes side by side (pytest-xdist) do not starve each other: a
check test's window must finish requests in its few seconds."""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
