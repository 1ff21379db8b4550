"""The port's examples (``symbolicregression_jl_tpu_torch/examples/``)
against the JAX package's scripts (``examples/``).

Each script's search is captured, not run: ``equation_search`` and
``SRRegressor.fit`` of both packages (and the multi-device example's rank
launcher) are replaced by a stand-in that records their arguments and
stops. Both must hand the search the same X and y, bit for bit, and
equal values in every ``Options`` field. Then each port example runs at
``niterations=1`` on the CPU and prints the JAX script's marker lines.
Neither the examples nor this capture import JAX from the port's side.
"""

import importlib
import importlib.util
import os

import numpy as np
import pytest

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.api import regressor as JREG
from symbolicregression_jl_tpu_torch import examples as PORT_EXAMPLES
from symbolicregression_jl_tpu_torch.api import regressor as SREG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARKERS = {
    "quickstart": ("best:", "pareto front (complexity, loss, equation):", "train MSE:"),
    "custom_initial_population": (),
    "llm_in_the_loop": ("round 0: best loss", "final best:"),
    "template_expression": ("best template instance:", "loss:"),
    "parametric_expression": ("best parametric form:", "loss:", "fitted per-class parameters:"),
    "dimensional_analysis": ("best dimensionally-consistent law:", "loss:"),
    "recorder_genealogy": ("accepted events across",),
    "multi_device": ("devices:",),
}
# The pareto rows: "  <complexity>  <loss>  <equation>".
PARETO_ROW = r"^\s+\d+\s+\S+\s+\S"


class _Captured(Exception):
    pass


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_examples_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture(monkeypatch, pkg, reg, launcher=None):
    """Stand-ins for the package's search entry points: the first call
    records (X, y, options, the other keywords) and stops."""
    seen = {}

    def search(X, y, *, options=None, **kw):
        seen.update(X=np.asarray(X), y=np.asarray(y), options=options, kw=kw)
        raise _Captured

    def fit(self, X, y, **kw):
        seen.update(X=np.asarray(X), y=np.asarray(y), options=self._make_options(), kw=kw,
                    niterations=self.niterations)
        raise _Captured

    monkeypatch.setattr(pkg, "equation_search", search, raising=False)
    monkeypatch.setattr(reg.SRRegressor, "fit", fit)
    return seen


def _norm(name, v):
    """An Options value in a form both packages share."""
    if name == "expression_spec" and v is not None:
        st = getattr(v, "structure", None)
        return (type(v).__name__, getattr(v, "max_parameters", None),
                None if st is None else (st.expr_keys, st.num_features, st.n_variables,
                                         st.param_keys, st.num_params))
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_norm(name, x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(name, x) for k, x in v.items()}
    return getattr(v, "__name__", None) or repr(v)


def _arg(seen, k):
    """A search argument as given: a keyword, or a RuntimeOptions field
    (False, a flag's default, reads as not given)."""
    if k in seen:
        v = seen[k]
    elif k in seen["kw"]:
        v = seen["kw"][k]
    else:
        v = getattr(seen["kw"].get("runtime_options"), k, None)
    return None if v is False else v


def _port_capture(name, monkeypatch):
    mod = importlib.import_module(f"symbolicregression_jl_tpu_torch.examples.{name}")
    if name == "multi_device":
        seen = {}

        def launcher(target, nranks, *, kwargs, **kw):
            seen.update(X=kwargs["X"], y=kwargs["y"], options=mod._options(S), kw=kwargs)
            raise _Captured

        monkeypatch.setattr("symbolicregression_jl_tpu_torch.parallel.launch.run_ranks",
                            launcher)
    else:
        seen = _capture(monkeypatch, S, SREG)
    with pytest.raises(_Captured):
        mod.main(device="cpu")
    return mod, seen


@pytest.mark.parametrize("name", PORT_EXAMPLES.EXAMPLES)
def test_example_matches_the_jax_script_and_runs(name, monkeypatch, capsys):
    jax_seen = _capture(monkeypatch, J, JREG)
    with pytest.raises(_Captured):
        _jax_example(name).main()
    mod, port_seen = _port_capture(name, monkeypatch)
    monkeypatch.undo()
    for k in ("X", "y"):
        a, b = jax_seen[k], port_seen[k]
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k
    jo, so = jax_seen["options"], port_seen["options"]
    fields = sorted(set(vars(jo)) & set(vars(so)))
    assert len(fields) > 80
    for f in fields:
        a, b = _norm(f, getattr(jo, f)), _norm(f, getattr(so, f))
        if f == "recorder_file" and a is not None:
            # each run writes into a temporary directory of its own
            a, b = os.path.basename(a), os.path.basename(b)
        assert a == b, f
    for k in ("niterations", "X_units", "y_units", "initial_population", "guesses", "seed",
              "return_state", "saved_state"):
        assert _arg(jax_seen, k) == _arg(port_seen, k), k
    if "category" in jax_seen["kw"]:
        assert np.array_equal(jax_seen["kw"]["category"], port_seen["kw"]["category"])

    capsys.readouterr()
    kw = dict(rounds=2) if name == "llm_in_the_loop" else {}
    mod.main(niterations=1, device="cpu", **kw)
    out = capsys.readouterr().out
    for marker in MARKERS[name]:
        assert marker in out, (name, marker)
    if name in ("quickstart", "custom_initial_population", "multi_device"):
        import re

        assert re.search(PARETO_ROW, out, re.M), name


def test_examples_import_no_jax():
    """The port's examples read no JAX and nothing of the JAX package."""
    import ast

    folder = os.path.dirname(PORT_EXAMPLES.__file__)
    for f in sorted(os.listdir(folder)):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(folder, f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "symbolicregression_jl_tpu"), (f, n)
    assert set(PORT_EXAMPLES.EXAMPLES) == {
        f[:-3] for f in os.listdir(os.path.join(ROOT, "examples")) if f.endswith(".py")}
