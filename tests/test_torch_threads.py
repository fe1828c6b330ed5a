"""The fixture the port's test modules share (this module holds no test):
under pytest-xdist, each worker's torch runs its CPU ops on its share of
the cores.

pytest-xdist runs the suite in several worker processes on one machine
(six in ``pytest -n 6``). torch's default intra-op pool (a thread per
core) then puts a pool per worker on the same cores, and the port's plain
versions are mostly small ops: every one wakes a pool whose threads spin
against the other workers'. A share of
the cores is faster there by an order of magnitude (a smoke-size serve:
2.4 s on one thread against 32.9 s on eight, beside seven busy processes);
run alone, the tests keep every core. Values do not depend on it: the
plain versions fix their sum orders, and the ternary products are exact
integers."""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def share_cpu_threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = torch.get_num_threads()
    torch.set_num_threads(max(1, n // workers))
    yield
    torch.set_num_threads(n)
