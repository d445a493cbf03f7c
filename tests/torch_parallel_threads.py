"""The CPU thread pools of the port's tests (``tests/test_torch_*.py``).

The suite runs several pytest-xdist workers side by side, so every pool a
worker keeps beyond one thread competes for the cores of the others:

- torch's own: each test file sets ``torch.set_num_threads(1)``;
- numpy's and SciPy's OpenBLAS, eight threads each by default. After a
  BLAS call its threads spin while they wait for more work, so a test that
  makes many small numpy products keeps several cores busy doing nothing.

``one_blas_thread`` is an autouse module fixture: a test module that
imports it runs its tests with both OpenBLAS pools at one thread, and the
pools are restored when the module ends, so other modules in the same
worker (the JAX package's tests among them) run as before. Processes
started inside it (the multi-GPU tests' spawned ranks, the JAX-free
subprocesses) read ``OPENBLAS_NUM_THREADS`` and start with one thread too.
"""
import os

import pytest


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    old = os.environ.get("OPENBLAS_NUM_THREADS")
    os.environ["OPENBLAS_NUM_THREADS"] = "1"
    try:
        try:
            import scipy.linalg  # noqa: F401  (loads SciPy's OpenBLAS)
            from threadpoolctl import threadpool_limits
        except ImportError:  # no threadpoolctl: the environment only
            yield
        else:
            with threadpool_limits(1, user_api="blas"):
                yield
    finally:
        if old is None:
            os.environ.pop("OPENBLAS_NUM_THREADS", None)
        else:
            os.environ["OPENBLAS_NUM_THREADS"] = old
