"""Shared set-up of the port's tests (``tests/test_torch_*.py``): one
PyTorch intra-op thread in every test process and in every rank it spawns,
and a cheaper compile of the reference's programs (:func:`reference_jit`).

The tests run in several pytest-xdist workers at once, and each spawned
mesh runs several ranks beside them.  At PyTorch's default of one thread a
core in every one of those processes the host is oversubscribed many times
over, and the port's side (many small ops) waits on its own threads.

Each ``tests/test_torch_*.py`` takes the fixture with
``from torch_testing import one_thread  # noqa: F401`` (pytest finds an
autouse fixture among a module's globals); each rank entry of the rank
files (``tests/torch_*_ranks.py``) starts with
``torch.set_num_threads(1)``, and the tests that spawn ranks do so inside
``ranks_one_thread()``.
``tests/test_torch_imports.py`` holds every file to this.
"""
import contextlib
import functools
import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module's tests; the old count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def ranks_one_thread():
    """``OMP_NUM_THREADS=1`` in the environment that processes started
    inside the block inherit (the torch ranks); restored after."""
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = saved


# XLA's options for the reference's programs in the port's tests: the same
# HLO, compiled without LLVM's optimization passes.  These programs run a
# few times on reduced shapes, so compiling them is most of their cost.
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def reference_jit(fun, **kwargs):
    """``jax.jit(fun, **kwargs)`` compiled with :data:`FAST_COMPILE`.  The
    options belong to this jit alone, so nothing else in the process is
    compiled with them (JAX's global ``jax_disable_most_optimizations``
    is not part of the jit cache's key).  Called inside another jit (a
    reference batcher's step takes the model's entry points), it is the
    plain ``jax.jit``: the outer program is compiled with its own
    options."""
    import jax
    fast = jax.jit(fun, compiler_options=FAST_COMPILE, **kwargs)
    nested = jax.jit(fun, **kwargs)

    @functools.wraps(fun)
    def call(*args, **kw):
        traced = any(isinstance(x, jax.core.Tracer)
                     for x in jax.tree_util.tree_leaves((args, kw)))
        return (nested if traced else fast)(*args, **kw)
    return call
