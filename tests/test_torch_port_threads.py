"""The test processes' thread budget (`torch_port_fixtures.thread_budget`):
each xdist worker gets its share of the host's cores, in torch and in the
processes its tests start; a single test process keeps every core."""
import os
import subprocess
import sys

import pytest
import torch

from torch_port_fixtures import thread_budget


@pytest.mark.parametrize("cores, environ, threads", [
    (8, {}, 8),
    (8, {"PYTEST_XDIST_WORKER_COUNT": "1"}, 8),
    (8, {"PYTEST_XDIST_WORKER_COUNT": "2"}, 4),
    (8, {"PYTEST_XDIST_WORKER_COUNT": "6"}, 1),
    (4, {"PYTEST_XDIST_WORKER_COUNT": "6"}, 1),
    (8, {"PYTEST_XDIST_WORKER_COUNT": "6", "OMP_NUM_THREADS": "3"}, 3),
])
def test_budget_shares_the_cores(cores, environ, threads):
    assert thread_budget(environ, cores) == threads


def test_workers_run_within_the_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    cores = len(os.sched_getaffinity(0))
    assert 1 <= torch.get_num_threads() * workers <= max(cores, workers)
    if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
        assert torch.get_num_threads() == thread_budget()


def test_subprocess_inherits_the_budget():
    names = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")
    out = subprocess.run(
        [sys.executable, "-c",
         f"import os, torch; print([os.environ.get(n) for n in {names}], "
         "torch.get_num_threads())"],
        capture_output=True, text=True, check=True).stdout.strip()
    want = [os.environ.get(n) for n in names]
    assert out == f"{want} {torch.get_num_threads()}"
