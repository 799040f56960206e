"""Helpers shared by the port's CPU tests (`tests/test_torch_*.py`)."""

import contextlib

import torch


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op CPU threads set to n for the block. The suite runs
    in several worker processes on one machine; each torch op spreading
    over every core in each of them oversubscribes the cores, and OpenMP's
    waiting threads then slow the ops by orders of magnitude."""
    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)
