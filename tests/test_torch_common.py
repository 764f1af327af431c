"""Helpers shared by the tests/test_torch_* files (this module holds no tests)."""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port's CPU tests on one intra-op thread: their tensors are
    small, and the JAX test files share the machine's cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def asdict(x):
    """A JAX stage result (NamedTuple tree) as dicts of numpy arrays, the
    form classpp_public_torch.interop takes."""
    if hasattr(x, "_asdict"):
        return {k: asdict(v) for k, v in x._asdict().items()}
    if x is None or isinstance(x, (int, float, str, tuple)):
        return x
    return np.asarray(x)
