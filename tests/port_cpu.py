"""How the port's test files share the CPU, imported by every
``tests/test_torch_*.py`` of the port.

The tier-1 command runs the suite in six xdist workers, one file per worker
at a time, on a machine of a few cores. Its wall is set by
``tests/test_parallel.py``, a JAX file that runs in one worker from the
start to the end on one core. The port's files keep out of its way:

- torch runs on one thread: their shapes are small, so more threads only
  add contention;
- :func:`yield_cpu`, an autouse fixture that each file imports, lowers the
  worker's CPU priority while the file runs and restores it after, so the
  next file in that worker runs as before.
"""

import os

import pytest
import torch

torch.set_num_threads(1)

NICE = 10   # a nice-0 thread gets ~9x a nice-10 thread's share of a busy core


def _renice(n):
    """Every thread of this process to niceness ``n`` (on Linux niceness is
    per thread, and a new thread takes its creator's)."""
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:   # no /proc: leave the priority as it is
        return
    for tid in tids:
        try:
            os.setpriority(os.PRIO_PROCESS, int(tid), n)
        except OSError:   # the thread has ended, or lowering it back is not allowed
            pass


@pytest.fixture(autouse=True, scope="module")
def yield_cpu():
    """Run the importing test file at niceness :data:`NICE`, then restore
    the worker's own."""
    before = os.getpriority(os.PRIO_PROCESS, 0)
    _renice(max(before, NICE))
    yield
    _renice(before)
