"""Helpers for the tests that hold the PyTorch port against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side's outputs come back as numpy, the port's as CPU tensors.
"""

import dataclasses
import os

import jax
import numpy as np
import torch

from symbolicregression_jl_tpu_torch import interop


def cap_torch_threads() -> int:
    """Under pytest-xdist, give each worker cpu_count // workers of torch's
    intra-op threads (at least one). The pool defaults to every CPU in
    each worker; the port's tests run many small eager ops, and six
    workers' pools on eight CPUs spin against each other (one slow case
    took 741 s with six copies at the default and 11 s with one thread
    each). Runs without xdist keep the default. Returns the count."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if "PYTEST_XDIST_WORKER" in os.environ and workers > 0:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    return torch.get_num_threads()


cap_torch_threads()

TREE_FIELDS = ("arity", "op", "feat", "length")
POP_INT_FIELDS = ("birth", "ref", "parent", "complexity")


def to_np(x):
    """A JAX array, torch tensor or numpy array as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def key_words(key) -> np.ndarray:
    """uint32 key data of a typed or raw JAX key."""
    if jax.dtypes.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    return np.asarray(key, dtype=np.uint32)


def port_key(key):
    return interop.key(key_words(key), device="cpu")


def numpy_state(state):
    """The JAX engine's SearchDeviceState as numpy, key as uint32 words."""
    return jax.tree.map(np.asarray, dataclasses.replace(
        state, key=jax.random.key_data(state.key), telem=None))


def problem(seed: int, n: int = 257, nfeatures: int = 3):
    """X (n, F) and y = x1*x1 + cos(x2), float32."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, nfeatures)).astype(np.float32)
    y = (X[:, 0] * X[:, 0] + np.cos(X[:, 1])).astype(np.float32)
    return X, y


def assert_trees_equal(jt, pt, const_rtol=1e-5):
    """Integer tree fields equal; constants within ``const_rtol`` with
    non-finite values in the same places."""
    for f in TREE_FIELDS:
        a, b = to_np(getattr(jt, f)), to_np(getattr(pt, f))
        assert np.array_equal(a, b), f"tree field {f} differs at {np.argwhere(a != b)[:5]}"
    a, b = to_np(jt.const), to_np(pt.const)
    assert_close(a, b, const_rtol, "const")


def assert_close(a, b, rtol, what=""):
    """Within ``rtol`` where finite; NaN and +-inf in the same places."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    fa, fb = np.isfinite(a), np.isfinite(b)
    assert np.array_equal(fa, fb), f"{what}: finite in different places"
    assert np.array_equal(np.isnan(a), np.isnan(b)), f"{what}: NaN in different places"
    assert np.array_equal(a[np.isinf(a)], b[np.isinf(b)]), f"{what}: inf signs differ"
    np.testing.assert_allclose(a[fa], b[fb], rtol=rtol, atol=0, err_msg=what)


def assert_pops_equal(jp, pp, rtol=1e-5):
    """PopulationState: integer fields equal, costs and losses within rtol."""
    assert_trees_equal(jp.trees, pp.trees)
    for f in POP_INT_FIELDS:
        a, b = to_np(getattr(jp, f)), to_np(getattr(pp, f))
        assert np.array_equal(a, b), f"population field {f} differs"
    assert_close(to_np(jp.cost), to_np(pp.cost), rtol, "cost")
    assert_close(to_np(jp.loss), to_np(pp.loss), rtol, "loss")
