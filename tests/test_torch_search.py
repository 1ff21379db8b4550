"""The port's `equation_search` end to end on the CPU, its refusals, and
its independence from JAX.

The search runs the plain-expression path: eager interpreter on the CPU
(the CUDA kernel takes its place on a card). One seed gives one hall of
fame; a short search on y = x1*x1 + cos(x2) gets below a stated loss.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu_torch.evolve.engine import Engine
from symbolicregression_jl_tpu_torch.ops.fused_eval import PROGRAM_EVAL

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "symbolicregression_jl_tpu_torch"


def _problem(n: int = 200, seed: int = 0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    y = (X[:, 0] * X[:, 0] + np.cos(X[:, 1])).astype(np.float32)
    return X, y


def _options(**kw):
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=12,
                populations=4, population_size=32, ncycles_per_iteration=20,
                tournament_selection_n=8, should_optimize_constants=False, save_to_file=False)
    base.update(kw)
    return S.Options(**base)


def _summary(hof):
    return [(e.complexity, e.loss, e.equation_string()) for e in hof.entries]


@pytest.fixture(scope="module")
def two_runs():
    X, y = _problem()
    return [S.equation_search(X, y, options=_options(), niterations=4, seed=0, device="cpu")
            for _ in range(2)]


def test_one_seed_one_hall_of_fame(two_runs):
    a, b = two_runs
    assert _summary(a) == _summary(b)
    assert len(a.entries) > 0


def test_search_reaches_stated_loss(two_runs):
    """Four iterations of 4 islands x 32 members find at least x1*x1:
    a mean squared error at most 0.5, against 8.0 for the mean of y."""
    best = min(two_runs[0].entries, key=lambda e: e.loss)
    assert np.isfinite(best.loss) and best.loss <= 0.5, _summary(two_runs[0])
    front = two_runs[0].pareto_frontier()
    assert [e.complexity for e in front] == sorted(e.complexity for e in front)


def test_search_stops_on_max_evals_and_early_stop():
    X, y = _problem(n=64)
    hof = S.equation_search(X, y, options=_options(max_evals=1, ncycles_per_iteration=2),
                            niterations=50, seed=1, device="cpu")
    assert len(hof.entries) > 0
    stop = _options(ncycles_per_iteration=2, early_stop_condition=lambda loss, c: True)
    assert len(S.equation_search(X, y, options=stop, niterations=50, seed=1,
                                 device="cpu").entries) > 0


def test_kernel_wrapper_not_launched_on_cpu():
    X, y = _problem(n=64)
    before = PROGRAM_EVAL.launches
    S.equation_search(X, y, options=_options(ncycles_per_iteration=2, turbo=True),
                      niterations=1, seed=2, device="cpu")
    assert PROGRAM_EVAL.launches == before


@pytest.mark.parametrize("kw", [
    dict(should_optimize_constants=True),
    dict(batching=True),
    dict(staged_eval=True),
    dict(eval_precision="bf16"),
    dict(telemetry=True),
    dict(use_recorder=True),
    dict(dimensional_constraint_penalty=1000.0),
    dict(loss_function=lambda pred, y, w: 0.0),
])
def test_options_outside_the_slice_refuse(kw):
    base = dict(binary_operators=["+", "*"], save_to_file=False)
    base.setdefault("should_optimize_constants", False)
    base.update(kw)
    opts = S.Options(**base)
    with pytest.raises(NotImplementedError, match="PyTorch port"):
        Engine(opts, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="PyTorch port"):
        S.equation_search(*_problem(n=16), options=opts, niterations=1, device="cpu")


def test_default_options_refuse_without_constant_optimizer_off():
    with pytest.raises(NotImplementedError, match="should_optimize_constants"):
        Engine(S.Options(save_to_file=False), 2, device="cpu")


@pytest.mark.parametrize("kw", [dict(resume="auto"), dict(saved_state=object()),
                                dict(X_units=["m", "s"]), dict(return_state=True),
                                dict(runtime_options=object()), dict(dtype=np.float64),
                                dict(guesses=["x1"])])
def test_search_arguments_outside_the_slice_refuse(kw):
    with pytest.raises(NotImplementedError, match="PyTorch port"):
        S.equation_search(*_problem(n=16), options=_options(), niterations=1, device="cpu",
                          **kw)


def test_entry_points_refuse_missing_cuda(monkeypatch):
    """Without a card and without device="cpu" the entry points raise;
    they never carry on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _problem(n=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.make_dataset(X, y)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(_options(), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.equation_search(X, y, options=_options(), niterations=1)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "symbolicregression_jl_tpu"), (path, mod)


def test_port_search_runs_without_jax_loaded():
    """A fresh interpreter runs a tiny port search and never loads JAX or
    the JAX package."""
    code = (
        "import sys, json, numpy as np\n"
        "import symbolicregression_jl_tpu_torch as S\n"
        "X = np.random.default_rng(0).normal(size=(32, 2)).astype(np.float32)\n"
        "y = X[:, 0] * 2.0\n"
        "o = S.Options(binary_operators=['+', '*'], populations=2, population_size=16,\n"
        "              ncycles_per_iteration=2, tournament_selection_n=4, maxsize=8,\n"
        "              should_optimize_constants=False, save_to_file=False)\n"
        "S.equation_search(X, y, options=o, niterations=1, seed=0, device='cpu')\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "      ('jax', 'jaxlib', 'symbolicregression_jl_tpu'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits nonzero and prints no result without a card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

