"""Helpers shared by the parity tests of the PyTorch port (test_torch_*.py).

A test module imports ``one_torch_thread`` to make it an autouse fixture of
that module, and ``close`` for array comparisons.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU among several
    pytest workers, torch's default of a thread per core oversubscribes
    it, and these tensors are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol):
    """max|got - want| <= rtol * max|want|: relative to the array's scale,
    so entries near zero are held to the same absolute error as the rest."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * scale)
