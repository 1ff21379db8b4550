"""The port's search API and minibatching against the JAX package.

``rng.randint`` must give ``jax.random.randint``'s bits; one batched engine
iteration (``batching=True``) from the same state and key must draw the
same batch and end with the same integer structures and evaluation count,
costs within rtol 1e-5; ``_seed_population`` must seed the same trees,
births, banks and key. End to end on the CPU: guesses and
``initial_population`` (nested per output, with fitted banks), several
outputs, ``return_state`` and ``saved_state``, ``warmup`` and the output
files' location. Sizes: 2-4 islands x 16 members, a few cycles; inputs
from a seed with numpy; the JAX side runs as its own tests run it on the
CPU (the eager interpreter on both sides, ``turbo=False``).
"""

import dataclasses
import os
import pathlib
import warnings

import jax
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.api import search as JA
from symbolicregression_jl_tpu.evolve.engine import Engine as JEngine
from symbolicregression_jl_tpu.models import ParametricExpressionSpec as JSpec
from symbolicregression_jl_tpu.ops.fused_eval import strided_sample_indices
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.api import search as SA
from symbolicregression_jl_tpu_torch.evolve import rng as SR
from symbolicregression_jl_tpu_torch.evolve.engine import Engine as SEngine
from symbolicregression_jl_tpu_torch.models import template_spec
from symbolicregression_jl_tpu_torch.ops.encoding import decode_tree

from torch_parity import (assert_close, assert_pops_equal, assert_trees_equal, numpy_state,
                          port_key, problem, to_np)

ROOT = pathlib.Path(__file__).resolve().parent.parent
MAXSIZE = 15


def _bits(x):
    return to_np(x).view(np.uint32)


# ---------------------------------------------------------------------------
# rng.randint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_randint_bits_equal_jax(seed):
    """``randint(key, (B,), 0, n)`` equals ``jax.random.randint`` for powers
    of two and not, n = 1, spans past 2^16 (where JAX's uint32 multiplier
    wraps) and several B."""
    jk = jax.random.key(seed)
    for n in (1, 2, 3, 50, 64, 1000, 10_000, 65_537, 100_003, 2**31 - 1):
        for B in (1, 8, 50, 333):
            want = np.asarray(jax.random.randint(jk, (B,), 0, n))
            got = to_np(SR.randint(port_key(jk), (B,), 0, n))
            assert got.dtype == np.int32 and np.array_equal(want, got), (n, B)


# ---------------------------------------------------------------------------
# One batched engine iteration
# ---------------------------------------------------------------------------


def _config(**kw):
    base = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"],
                maxsize=MAXSIZE, should_optimize_constants=False, save_to_file=False,
                populations=2, population_size=16, ncycles_per_iteration=3,
                tournament_selection_n=8, annealing=False, turbo=False, batching=True,
                batch_size=8)
    base.update(kw)
    return J.Options(**base), S.Options(**base)


def _data(seed, jo, n=64):
    X, y = problem(seed, n=n)
    jds = J.make_dataset(X, y)
    jds.update_baseline_loss(jo.elementwise_loss)
    return jds, interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")


@pytest.fixture(scope="module")
def batched_engines():
    """JAX and port engines per configuration, built once so the JAX side
    compiles once."""
    cache = {}

    def get(staged):
        if staged not in cache:
            kw = dict(staged_eval=True, staged_sample_rows=4) if staged else {}
            jo, so = _config(**kw)
            cache[staged] = (jo, JEngine(jo, 3), SEngine(so, 3, device="cpu"))
        return cache[staged]

    return get


# Annealing is off: its temperature-0 ties part the two packages on a 1-ULP
# cost difference (ROADMAP.md queue 3), as in test_torch_evolve.py.
@pytest.mark.parametrize("staged,seed", [(False, 0), (False, 1), (False, 2), (True, 3),
                                         (True, 4)])
def test_batched_run_iteration_equal(batched_engines, staged, seed):
    """``batching=True, batch_size=8`` of 64 rows: the batch indices (and,
    staged, the screen's rows: the batch's strided sample) equal the JAX
    package's; after one iteration the populations' integer fields, the
    hall of fame's structure, the counters, the key and ``num_evals``
    (scaled by 8 / 64) are equal and costs agree within rtol 1e-5."""
    jo, je, se = batched_engines(staged)
    jds, sd = _data(seed, jo)
    jkey = jax.random.key(seed)
    js = je.init_state(jkey, jds.data, 2)
    ss = interop.search_state(numpy_state(js), device="cpu")

    jb = np.asarray(jax.random.randint(jax.random.split(js.key, 5)[1], (8,), 0, 64))
    batch = se.draw_batch(SR.split(ss.key, 5)[1], sd)
    assert np.array_equal(to_np(batch.y), np.asarray(jds.data.y)[jb])
    assert np.array_equal(to_np(batch.Xt), np.asarray(jds.data.Xt)[:, jb])
    assert batch.Xt.is_contiguous()
    if staged:
        screen = jb[strided_sample_indices(8, 4)]
        assert np.array_equal(to_np(batch.strided_sample(4).y), np.asarray(jds.data.y)[screen])

    js2 = je.run_iteration(js, jds.data, MAXSIZE)
    ss2 = se.run_iteration(ss, sd, MAXSIZE)
    assert_pops_equal(js2.pops, ss2.pops)
    ex = to_np(js2.hof.exists)
    assert np.array_equal(ex, to_np(ss2.hof.exists))
    assert_close(to_np(js2.hof.cost)[ex], to_np(ss2.hof.cost)[ex], 1e-5, "hof cost")
    assert np.array_equal(to_np(js2.hof.trees.length)[ex], to_np(ss2.hof.trees.length)[ex])
    assert float(js2.num_evals) == float(ss2.num_evals)
    assert float(ss2.num_evals) != float(ss.num_evals) + 3 * 32 + 32   # scaled, not full
    assert np.array_equal(to_np(js2.birth), to_np(ss2.birth))
    assert np.array_equal(to_np(js2.ref), to_np(ss2.ref))
    assert np.array_equal(to_np(jax.random.key_data(js2.key)), _bits(ss2.key))


def test_batched_iteration_with_optimizer_counts_scaled_f_calls():
    """With the constant optimizer on, one batched iteration counts the
    optimizer's f_calls at batch_size / n as the JAX package does: the
    same num_evals from the same state and key."""
    jo, so = _config(should_optimize_constants=True, optimizer_probability=0.5,
                     optimizer_iterations=2, optimizer_nrestarts=0)
    jds, sd = _data(5, jo)
    je, se = JEngine(jo, 3), SEngine(so, 3, device="cpu")
    js = je.init_state(jax.random.key(5), jds.data, 2)
    ss = interop.search_state(numpy_state(js), device="cpu")
    js2 = je.run_iteration(js, jds.data, MAXSIZE)
    ss2 = se.run_iteration(ss, sd, MAXSIZE)
    assert float(js2.num_evals) == float(ss2.num_evals)
    assert np.array_equal(to_np(jax.random.key_data(js2.key)), _bits(ss2.key))


def _param_problem(seed, n=96):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    cls = rng.integers(0, 3, n)
    y = (np.array([1.0, 2.0, 3.0])[cls] * np.cos(X[:, 0]) + X[:, 1]).astype(np.float32)
    return X, y, cls


@pytest.mark.parametrize("turbo", [False, True])
def test_parametric_batched_search_runs(turbo):
    """A parametric search with minibatches (the batch's class column
    gathered with its rows; ``turbo`` routes it through #1p's wrapper,
    its plain version here) ends with finite hall-of-fame losses."""
    X, y, cls = _param_problem(0)
    o = S.Options(binary_operators=["+", "*"], unary_operators=["cos"], maxsize=10,
                  populations=2, population_size=16, ncycles_per_iteration=3,
                  tournament_selection_n=4, batching=True, batch_size=16, turbo=turbo,
                  expression_spec=S.ParametricExpressionSpec(max_parameters=1),
                  optimizer_probability=0.3, optimizer_iterations=2, save_to_file=False)
    hof = S.equation_search(X, y, options=o, niterations=2, seed=0, extra={"class": cls},
                            device="cpu", verbosity=0)
    losses = np.array([e.loss for e in hof.entries])
    assert len(losses) and np.isfinite(losses).all()


@pytest.mark.parametrize("turbo", [False, True])
def test_template_batched_search_runs(turbo):
    """A template search with minibatches (``turbo``: kernel #4's and #5's
    wrappers, their plain versions here) ends with finite hall-of-fame
    losses."""
    rng = np.random.default_rng(1)
    X = rng.uniform(-2, 2, (96, 2)).astype(np.float32)
    y = ((1.5 * X[:, 0]) ** 2 + np.cos(2 * X[:, 1])).astype(np.float32)
    spec = template_spec(expressions=("f", "g"))(lambda f, g, x1, x2: f(x1) * f(x1) + g(x2))
    o = S.Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=12,
                  populations=2, population_size=16, ncycles_per_iteration=3,
                  tournament_selection_n=4, batching=True, batch_size=16, turbo=turbo,
                  expression_spec=spec, optimizer_probability=0.2, optimizer_iterations=2,
                  save_to_file=False)
    hof = S.equation_search(X, y, options=o, niterations=2, seed=0, device="cpu", verbosity=0)
    losses = np.array([e.loss for e in hof.entries])
    assert len(losses) and np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# _seed_population against the JAX package
# ---------------------------------------------------------------------------

# Near the law but not on it: an exact fit's loss is rounding noise, which
# the two packages' row sums do not share.
SEEDS = ["x1 * x1 + 0.9 * cos(x2)", "x1 * x1", "cos(x2) + 0.5", "x3 - x1",
         "x1 * x1 + 0.9 * cos(x2)"]


@pytest.mark.parametrize("mode", ["tile", "replace_worst"])
def test_seed_population_equal(mode):
    """Both modes seed the same carried-over state identically: trees,
    births and the next key equal, seed costs within rtol 1e-5, and (for
    guesses) the same hall of fame."""
    jo, so = _config(batching=False, populations=2, population_size=16)
    jds, sd = _data(7, jo)
    je, se = JEngine(jo, 3), SEngine(so, 3, device="cpu")
    js = je.init_state(jax.random.key(7), jds.data, 2)
    ss = interop.search_state(numpy_state(js), device="cpu")
    jt = [J.parse_expression(s, jo.operators) for s in SEEDS]
    st = [S.parse_expression(s, so.operators) for s in SEEDS]
    js2 = JA._seed_population(je, js, jt, jds.data, mode=mode)
    ss2 = SA._seed_population(se, ss, st, sd, mode=mode)
    assert_pops_equal(js2.pops, ss2.pops)
    assert np.array_equal(to_np(jax.random.key_data(js2.key)), _bits(ss2.key))
    assert np.array_equal(to_np(js2.hof.exists), to_np(ss2.hof.exists))
    ex = to_np(js2.hof.exists)
    assert_close(to_np(js2.hof.cost)[ex], to_np(ss2.hof.cost)[ex], 1e-5, "hof cost")
    assert_trees_equal(jax.tree.map(lambda x: np.asarray(x)[ex], js2.hof.trees),
                       dataclasses.replace(ss2.hof.trees, **{
                           f: getattr(ss2.hof.trees, f)[torch.from_numpy(ex.copy())]
                           for f in ("arity", "op", "feat", "const", "length")}))
    if mode == "replace_worst":
        assert ex.any()


@pytest.mark.parametrize("with_bank", [False, True])
def test_parametric_seed_banks_equal(with_bank):
    """Parametric guesses get the JAX package's banks: a fresh normal bank
    drawn from the split key, or the fitted bank given with the guess."""
    base = dict(binary_operators=["+", "*"], unary_operators=["cos"], maxsize=10,
                populations=2, population_size=16, tournament_selection_n=4, turbo=False,
                save_to_file=False)
    jo = J.Options(expression_spec=JSpec(max_parameters=1), **base)
    so = S.Options(expression_spec=S.ParametricExpressionSpec(max_parameters=1), **base)
    X, y, cls = _param_problem(2)
    jds = J.make_dataset(X, y, extra={"class": cls})
    jds.update_baseline_loss(jo.elementwise_loss)
    sd = interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")
    je = JEngine(jo, 2, n_params=1, n_classes=3)
    se = SEngine(so, 2, device="cpu", n_params=1, n_classes=3)
    js = je.init_state(jax.random.key(2), jds.data, 2)
    ss = interop.search_state(numpy_state(js), device="cpu")
    exprs = ["p1 * cos(x1) + x2", "x1 * p1"]
    params = [np.array([1.1, 2.0, 2.9]), None] if with_bank else None
    js2 = JA._seed_population(je, js, [J.parse_expression(e, jo.operators) for e in exprs],
                              jds.data, mode="replace_worst", params=params)
    ss2 = SA._seed_population(se, ss, [S.parse_expression(e, so.operators) for e in exprs], sd,
                              mode="replace_worst", params=params)
    assert_pops_equal(js2.pops, ss2.pops)
    np.testing.assert_array_equal(to_np(js2.pops.params), to_np(ss2.pops.params))
    assert np.array_equal(to_np(jax.random.key_data(js2.key)), _bits(ss2.key))


def test_oversized_seed_is_skipped_with_a_warning():
    so = _config(batching=False, maxsize=7)[1]
    se = SEngine(so, 3, device="cpu")
    _, sd = _data(0, _config()[0])
    ss = se.init_state(SR.key(0), sd, 2)
    big = S.parse_expression("x1 * x2 + x3 * x1 + cos(x2)", so.operators)
    small = S.parse_expression("x1 * x1", so.operators)
    with pytest.warns(UserWarning, match="skipping"):
        out = SA._seed_population(se, ss, [big, small], sd, mode="tile")
    assert bool((out.pops.trees.length == 3).all())
    with pytest.warns(UserWarning, match="skipping"):
        same = SA._seed_population(se, ss, [big], sd, mode="tile")
    assert same is ss


def test_guess_is_in_the_hall_of_fame_after_iteration_1():
    """A guess enters the hall of fame when seeded and is there, at its
    complexity and with its loss, after the first iteration."""
    X, y = problem(3, n=64)
    o = _config(batching=False, populations=2)[1]
    hof = S.equation_search(X, y, options=o, niterations=1, seed=3, device="cpu", verbosity=0,
                            guesses=["x1 * x1 + cos(x2)"])
    want = S.string_tree(S.parse_expression("x1 * x1 + cos(x2)", o.operators))
    hit = [e for e in hof.entries if e.equation_string() == want]
    assert hit and hit[0].complexity == 6 and hit[0].loss <= 1e-10


# ---------------------------------------------------------------------------
# End to end: guesses, initial_population, several outputs, warm starts
# ---------------------------------------------------------------------------


def _search_options(**kw):
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=12,
                populations=2, population_size=16, ncycles_per_iteration=3,
                tournament_selection_n=4, should_optimize_constants=False, save_to_file=False)
    base.update(kw)
    return S.Options(**base)


def _baseline(y):
    return float(np.mean((y - np.mean(y)) ** 2))


@pytest.mark.parametrize("how", ["initial_population", "guesses", "pair"])
def test_exact_truth_seed_reaches_zero_loss(how):
    """The exact truth given as initial_population, as a guess, or as an
    (expression, None) pair gives a hall-of-fame loss at most 1e-10 of the
    baseline."""
    X, y = problem(4, n=64)
    seed = {"initial_population": dict(initial_population=["x1 * x1 + cos(x2)", "x1"]),
            "guesses": dict(guesses=["x1 * x1 + cos(x2)"]),
            "pair": dict(guesses=[("x1 * x1 + cos(x2)", None)])}[how]
    hof = S.equation_search(X, y, options=_search_options(), niterations=1, seed=4,
                            device="cpu", verbosity=0, **seed)
    assert min(e.loss for e in hof.entries) <= 1e-10 * _baseline(y)


def test_nested_guesses_per_output_and_return_state():
    """Two outputs: nested guesses seed each output with its own truth; a
    list of halls of fame comes back, and return_state gives one device
    state per output and the feature counts."""
    X, y = problem(5, n=64)
    Y = np.stack([y, X[:, 2] - X[:, 0]])
    state, hofs = S.equation_search(
        X, Y, options=_search_options(), niterations=1, seed=5, device="cpu", verbosity=0,
        guesses=[["x1 * x1 + cos(x2)"], ["x3 - x1"]], return_state=True)
    assert isinstance(hofs, list) and len(hofs) == 2 and len(state.device_states) == 2
    assert state.nfeatures == [3, 3] and state.iterations_done == 1
    for h, yy in zip(hofs, Y):
        assert min(e.loss for e in h.entries) <= 1e-10 * _baseline(yy)


def test_template_guess_and_initial_population():
    """Template seeds (a ``'f = ...; g = ...'`` string and a ``{key: expr}``
    dict) reach the exact law's zero loss."""
    rng = np.random.default_rng(2)
    X = rng.uniform(-2, 2, (64, 2)).astype(np.float32)
    y = (X[:, 0] * X[:, 0] + np.cos(X[:, 1])).astype(np.float32)
    spec = template_spec(expressions=("f", "g"))(lambda f, g, x1, x2: f(x1) * f(x1) + g(x2))
    o = _search_options(expression_spec=spec)
    for seed in (dict(guesses=["f = #1; g = cos(#1)"]),
                 dict(initial_population=[{"f": "#1", "g": "cos(#1)"}])):
        hof = S.equation_search(X, y, options=o, niterations=1, seed=0, device="cpu",
                                verbosity=0, **seed)
        assert min(e.loss for e in hof.entries) <= 1e-10 * _baseline(y)


def test_saved_state_runs_more_iterations_and_counts_evals_once():
    """saved_state runs niterations more; the total num_evals equals an
    uninterrupted run's (the saved device counters restart at 0)."""
    X, y = problem(6, n=64)
    o = _search_options()
    s2, h2 = S.equation_search(X, y, options=o, niterations=2, seed=6, device="cpu",
                               verbosity=0, return_state=True)
    s1, _ = S.equation_search(X, y, options=o, niterations=1, seed=6, device="cpu",
                              verbosity=0, return_state=True)
    sr, hr = S.equation_search(X, y, options=o, niterations=1, seed=6, device="cpu",
                               verbosity=0, return_state=True, saved_state=s1)
    assert sr.num_evals == s2.num_evals
    assert [(e.loss, e.equation_string()) for e in hr.entries] == [
        (e.loss, e.equation_string()) for e in h2.entries]
    # The warm start left s1 as it was: a second one gives the same result.
    _, hr2 = S.equation_search(X, y, options=o, niterations=1, seed=6, device="cpu",
                               verbosity=0, return_state=True, saved_state=s1)
    assert [(e.loss, e.equation_string()) for e in hr2.entries] == [
        (e.loss, e.equation_string()) for e in hr.entries]


def test_datasets_as_input_and_per_output_csvs(tmp_path):
    """X given as a list of port Datasets runs one output each; with
    save_to_file each output writes hall_of_fame_output{j}.csv and one
    checkpoint holds both device states."""
    X, y = problem(9, n=48)
    dss = [S.make_dataset(X, y, device="cpu", index=1),
           S.make_dataset(X, X[:, 0] * 2.0, device="cpu", index=2)]
    o = _search_options(save_to_file=True, output_directory=str(tmp_path))
    state, hofs = S.equation_search(dss, None, options=o, niterations=1, seed=0,
                                    device="cpu", verbosity=0, run_id="two",
                                    return_state=True)
    assert len(hofs) == 2 and len(state.device_states) == 2
    files = sorted(os.listdir(tmp_path / "two"))
    assert files == ["hall_of_fame_output1.csv", "hall_of_fame_output2.csv",
                     "search_state.pkl"]


def test_staged_bf16_batched_search_runs():
    """Minibatches with the staged screen taken from the batch and bf16
    value buffers (``turbo``: kernel 1b's wrapper, its plain version here)
    end with finite hall-of-fame losses."""
    X, y = problem(10, n=400)
    o = _search_options(batching=True, batch_size=200, staged_eval=True,
                        staged_sample_rows=64, eval_precision="bf16", turbo=True)
    hof = S.equation_search(X, y, options=o, niterations=2, seed=0, device="cpu",
                            verbosity=0)
    losses = np.array([e.loss for e in hof.entries])
    assert len(losses) and np.isfinite(losses).all()


def test_stop_hook_stops_at_the_boundary():
    X, y = problem(7, n=32)
    calls = []
    ropt = S.RuntimeOptions(niterations=5, seed=0, verbosity=0, return_state=True,
                            stop_hook=lambda: calls.append(1) or ("cancelled"
                                                                  if len(calls) == 2 else None))
    state, _ = S.equation_search(X, y, options=_search_options(), runtime_options=ropt,
                                 device="cpu")
    assert state.iterations_done == 2 and len(calls) == 2


def test_warmup_is_quiet_and_writes_nothing(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    S.warmup(_search_options(save_to_file=True, output_directory=str(tmp_path / "out")),
             nfeatures=2, n_rows=64, niterations=1, device="cpu")
    assert capsys.readouterr().out == ""
    assert list(tmp_path.iterdir()) == []


def test_search_with_files_writes_nothing_into_the_checkout(monkeypatch):
    """save_to_file=True with no output_directory, run from the repository
    root, writes under $TMPDIR/sr_outputs while the tests run
    (SYMBOLIC_REGRESSION_IS_TESTING, set by conftest): no run directory,
    CSV or checkpoint appears under the repository root."""
    monkeypatch.chdir(ROOT)
    before = set(os.listdir(ROOT))
    X, y = problem(8, n=32)
    S.equation_search(X, y, options=_search_options(save_to_file=True), niterations=1,
                      seed=0, device="cpu", verbosity=0, run_id="no_checkout_files")
    new = set(os.listdir(ROOT)) - before
    assert not [n for n in new if n == "outputs" or n.endswith(".csv") or "search_state" in n]
    assert not (ROOT / "outputs" / "no_checkout_files").exists()
    assert os.environ.get("SYMBOLIC_REGRESSION_IS_TESTING")
    out = os.path.join(os.environ.get("TMPDIR", "/tmp"), "sr_outputs", "no_checkout_files")
    assert os.path.exists(os.path.join(out, "hall_of_fame.csv"))
    assert os.path.exists(os.path.join(out, "search_state.pkl"))


def test_runtime_options_keep_the_jax_package_fields():
    """RuntimeOptions has the JAX package's fields and defaults (the ones
    of later slices included)."""
    jf = {f.name: f.default for f in dataclasses.fields(JA.RuntimeOptions)}
    sf = {f.name: f.default for f in dataclasses.fields(SA.RuntimeOptions)}
    assert jf.keys() == sf.keys()
    assert {k: v for k, v in jf.items() if k != "run_id"} == {
        k: v for k, v in sf.items() if k != "run_id"}


def test_hall_of_fame_decodes_guess_tree():
    """decode_tree round trip of a seeded guess (the hall of fame's decode
    path) prints the guess back."""
    so = _search_options()
    se = SEngine(so, 3, device="cpu")
    _, sd = _data(0, _config()[0])
    ss = se.init_state(SR.key(0), sd, 2)
    g = S.parse_expression("x1 * x1 + cos(x2)", so.operators)
    out = SA._seed_population(se, ss, [g], sd, mode="replace_worst")
    row = int(torch.argmin(out.hof.cost))
    t = decode_tree(*(to_np(f)[row] for f in out.hof.trees.fields()), so.operators)
    assert S.string_tree(t) == S.string_tree(g)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        SA._seed_population(se, ss, [], sd, mode="tile")
