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
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.evolve.engine import Engine
from symbolicregression_jl_tpu_torch.models import D, ParametricExpressionSpec, template_spec
from symbolicregression_jl_tpu_torch.ops.encoding import encode_population
from symbolicregression_jl_tpu_torch.ops.fused_eval import PROGRAM_EVAL

from torch_parity import cap_torch_threads

cap_torch_threads()

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
    dict(loss_function_expression="(prediction - target)^2"),
    dict(eval_dtype="float64"),
    dict(telemetry=True),
    dict(use_recorder=True),
    dict(dimensional_constraint_penalty=1000.0),
    dict(loss_function=lambda pred, y, w: 0.0),
    dict(expression_spec=template_spec(expressions=("f",))(lambda f, x1, x2: D(f, 1)(x1) + x2),
         should_optimize_constants=True),
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
    """The constant optimizer is in the port: the default Options (which
    turn it on) build an engine; with its bfloat16 line search asked for,
    an engine on the CPU builds with the float32 line search (kernel 2b
    runs only on the card, as the JAX package's interpret mode keeps f32)."""
    engine = Engine(S.Options(save_to_file=False), 2, device="cpu")
    assert engine.options.should_optimize_constants
    assert engine.opt_cfg.iterations == 8 and engine.opt_cfg.nrestarts == 2
    engine = Engine(S.Options(optimizer_bf16_linesearch=True, save_to_file=False), 2,
                    device="cpu")
    assert engine.options.optimizer_bf16_linesearch and not engine.opt_cfg.ls_bf16


def test_default_options_search_runs_the_constant_optimizer(monkeypatch):
    """equation_search with the default Options on the CPU runs the eager
    constant optimizer (turbo is off on the CPU) every iteration. Every
    option keeps its default except the depth, ncycles_per_iteration,
    cut from 380 to 20 to keep the test short."""
    from symbolicregression_jl_tpu_torch.evolve import engine as engine_module

    calls = []
    real = engine_module.optimize_constants_batch

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(engine_module, "optimize_constants_batch", counting)
    X, y = _problem(n=32)
    hof = S.equation_search(X, y, options=S.Options(ncycles_per_iteration=20), niterations=1,
                            seed=0, device="cpu")
    assert len(calls) == 1
    assert np.isfinite(min(e.loss for e in hof.entries))


@pytest.mark.parametrize("kw", [dict(y_units="m"),
                                dict(runtime_options=S.RuntimeOptions(n_data_shards=2)),
                                dict(X_units=["m", "s"]),
                                dict(runtime_options=S.RuntimeOptions(logger=object())),
                                dict(runtime_options=S.RuntimeOptions(mesh_runtime=True)),
                                dict(dtype=np.float64),
                                dict(runtime_options=S.RuntimeOptions(engine_cache=object())),
                                dict(extra={"weights2": [1.0]})])
def test_search_arguments_outside_the_slice_refuse(kw):
    with pytest.raises(NotImplementedError, match="PyTorch port"):
        S.equation_search(*_problem(n=16), options=_options(), niterations=1, device="cpu",
                          **kw)


def test_regressor_export_refuses():
    """latex() and sympy() of a fitted SRRegressor name the export slice."""
    X, y = _problem(n=16)
    model = S.SRRegressor(niterations=1, seed=0, device="cpu", binary_operators=["+", "*"],
                          populations=2, population_size=8, ncycles_per_iteration=2,
                          tournament_selection_n=4, should_optimize_constants=False,
                          save_to_file=False).fit(X, y)
    for export in (model.latex, model.sympy):
        with pytest.raises(NotImplementedError, match="PyTorch port"):
            export()


def test_progress_false_runs_and_progress_true_refuses():
    """progress=False asks for what the port does (no progress bar), as the
    JAX package's warmup passes it: the search runs. progress=True still
    refuses, naming the observability slice."""
    X, y = _problem(n=16)
    opts = _options(populations=2, population_size=8, ncycles_per_iteration=2,
                    tournament_selection_n=4)
    hof = S.equation_search(X, y, options=opts, niterations=1, seed=0, progress=False,
                            device="cpu")
    assert np.isfinite(min(e.loss for e in hof.entries))
    with pytest.raises(NotImplementedError, match="observability slice"):
        S.equation_search(X, y, options=opts, niterations=1, seed=0, progress=True,
                          device="cpu")


def test_parametric_search_on_the_cpu():
    """A parametric search runs through equation_search with a class
    column (y = 2 x1 + offset[class]; turbo=True, so candidates go
    through kernel #1p's wrapper, its plain version here, which counts no
    launch): its entries carry (1, 3) banks and print their parameter
    leaves; one seed gives one hall of fame; without the class column it
    raises ValueError; a guess with its fitted bank enters the hall of
    fame with that bank."""
    from symbolicregression_jl_tpu_torch.ops.fused_eval import PROGRAM_EVAL_PARAM

    rng = np.random.default_rng(3)
    X = rng.uniform(-2, 2, (96, 2)).astype(np.float32)
    cls = rng.integers(0, 3, 96)
    y = (2.0 * X[:, 0] + np.array([1.0, -2.0, 0.5])[cls]).astype(np.float32)
    o = _options(binary_operators=["+", "*"], unary_operators=[], maxsize=8,
                 expression_spec=ParametricExpressionSpec(max_parameters=1),
                 ncycles_per_iteration=4, turbo=True)
    before = PROGRAM_EVAL_PARAM.launches
    runs = [S.equation_search(X, y, options=o, niterations=2, seed=1, extra={"class": cls},
                              device="cpu") for _ in range(2)]
    assert PROGRAM_EVAL_PARAM.launches == before
    hof = runs[0]
    assert [(e.loss, e.equation_string()) for e in hof.entries] == [
        (e.loss, e.equation_string()) for e in runs[1].entries]
    assert all(e.params is not None and e.params.shape == (1, 3) for e in hof.entries)
    assert np.isfinite(min(e.loss for e in hof.entries))
    assert any("p1" in e.equation_string() for e in hof.entries)
    with pytest.raises(ValueError, match="class"):
        S.equation_search(X, y, options=o, niterations=1, device="cpu")
    bank = np.array([[1.0, -2.0, 0.5]])
    guessed = S.equation_search(X, y, options=o, niterations=1, seed=1, device="cpu",
                                guesses=[("2.0 * x1 + p1", bank)], extra={"class": cls})
    assert min(e.loss for e in guessed.entries) <= 1e-10


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
    ops = _options().operators
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        encode_population([S.parse_expression("x1 * 2.0", ops)], 4, ops)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interop.tensor(np.zeros(3, np.float32))


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


@pytest.mark.parametrize("spec", [
    "None",
    "template_spec(expressions=('f', 'g'))(lambda f, g, x1, x2: g(f(x1), x2))",
    "template_spec(expressions=('f',), parameters={'p': 1})"
    "(lambda f, x1, x2, p: f(x1) * p[0] + x2)",
    "S.ParametricExpressionSpec(max_parameters=1)",
])
def test_port_search_runs_without_jax_loaded(spec):
    """A fresh interpreter runs a tiny port search (plain, template,
    template with parameters, parametric with a class column) and never
    loads JAX or the JAX package."""
    code = (
        "import sys, json, numpy as np\n"
        "import symbolicregression_jl_tpu_torch as S\n"
        "from symbolicregression_jl_tpu_torch.models import template_spec\n"
        "X = np.random.default_rng(0).normal(size=(32, 2)).astype(np.float32)\n"
        "y = X[:, 0] * 2.0\n"
        "o = S.Options(binary_operators=['+', '*'], populations=2, population_size=16,\n"
        "              ncycles_per_iteration=2, tournament_selection_n=4, maxsize=8,\n"
        f"              expression_spec={spec}, save_to_file=False)\n"
        "extra = {'class': np.arange(32) % 3} if isinstance(o.expression_spec,\n"
        "    S.ParametricExpressionSpec) else None\n"
        "S.equation_search(X, y, options=o, niterations=1, seed=0, device='cpu', extra=extra)\n"
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

