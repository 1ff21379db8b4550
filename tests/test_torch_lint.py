"""graftlint of the PyTorch/CUDA port (``symbolicregression_jl_tpu_torch.lint``)
against the JAX package's, and the runtime audits of ``debug_checks``.

- The JAX package's fixture snippets of the framework-agnostic rules (GL006,
  GL007, GL009-GL014), read out of tests/test_lint_rules.py, give the same
  (rule, line) findings in both packages.
- Each restated rule GL001-GL005 flags its hazard and stays quiet on the
  clean counterpart.
- The port's own tree lints clean, the CLI's exit codes, the lock-order
  manifest is acyclic, and no module of the port imports JAX or the JAX
  package.
- ``validate_programs`` reports the same corruptions, with the same
  messages, as the JAX package's; an Engine with ``debug_checks=True``
  raises on a corrupted population where the JAX engine raises (the port
  before this check carried on).
Pure AST tests, but for the last two groups (tiny engines on the CPU).
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from symbolicregression_jl_tpu import lint as JL
from symbolicregression_jl_tpu.lint import runtime as JR
from symbolicregression_jl_tpu_torch import lint as SL
from symbolicregression_jl_tpu_torch.lint import lock_order as SLO
from symbolicregression_jl_tpu_torch.lint import runtime as SR
from symbolicregression_jl_tpu_torch.lint.cli import main as lint_main

import torch_parity  # noqa: F401  (caps torch's threads per xdist worker)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "symbolicregression_jl_tpu_torch"

# The rules both packages define alike: only the AST matters.
AGNOSTIC = {"GL006", "GL007", "GL009", "GL010", "GL011", "GL012", "GL013", "GL014"}


def _lint(src: str, path: str = "pkg/evolve/mod.py"):
    return SL.lint_source(textwrap.dedent(src), path)


def _ids(findings):
    return sorted({f.rule_id for f in findings})


# ---------------------------------------------------------------------------
# The JAX package's fixtures of the framework-agnostic rules
# ---------------------------------------------------------------------------


def _jax_fixtures():
    """(test name, source, path) of every ``_lint``/``_lint_serve`` call in
    the JAX package's GL006, GL007 and GL009-GL014 tests."""
    tree = ast.parse((ROOT / "tests" / "test_lint_rules.py").read_text())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        if not fn.name.startswith(("test_gl006", "test_gl007", "test_gl009", "test_gl010",
                                   "test_gl011", "test_gl012", "test_gl013", "test_gl014",
                                   "test_warden_rules")):
            continue
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id in ("_lint", "_lint_serve")):
                continue
            src = node.args[0].value
            path = "pkg/serve/mod.py" if node.func.id == "_lint_serve" else "pkg/evolve/mod.py"
            for kw in node.keywords:
                if kw.arg == "path":
                    path = kw.value.value
            if len(node.args) > 1:
                path = node.args[1].value
            out.append((fn.name, src, path))
    return out


FIXTURES = _jax_fixtures()


def test_jax_fixture_set_is_complete():
    names = {n for n, _, _ in FIXTURES}
    for rid in ("gl006", "gl007", "gl009", "gl010", "gl011", "gl012", "gl013", "gl014"):
        assert any(n.startswith(f"test_{rid}") for n in names), rid
    assert len(FIXTURES) >= 20


@pytest.mark.parametrize("name,src,path", FIXTURES, ids=[f[0] for f in FIXTURES])
def test_agnostic_rules_match_jax_on_its_fixtures(name, src, path):
    """Same rule codes at the same lines in both packages (exact)."""
    src = textwrap.dedent(src)
    jax_f = {(f.rule_id, f.line) for f in JL.lint_source(src, path) if f.rule_id in AGNOSTIC}
    port_f = {(f.rule_id, f.line) for f in SL.lint_source(src, path) if f.rule_id in AGNOSTIC}
    assert port_f == jax_f


# ---------------------------------------------------------------------------
# GL001-GL005, restated for the port
# ---------------------------------------------------------------------------

HAZARDS = {
    "GL001": ("""
        from . import rng

        def f(key):
            a = rng.uniform(key, (3,))
            b = rng.normal(key, (3,))
            return a + b
        """, """
        from . import rng

        def f(key, xs):
            k1, k2 = rng.split(key)
            out = []
            for i in range(3):
                out.append(rng.uniform(rng.fold_in(k1, i), (2,)))
            return rng.normal(k2, (3,)), out
        """),
    "GL002": ("""
        import numpy as np
        import torch

        def mutate(x):
            return x + np.random.normal() + torch.rand(3)
        """, """
        import numpy as np
        from . import rng

        def mutate(x, key):
            table = np.asarray([1.0, 2.0])
            return x + rng.uniform(key, (3,)) + table[0]
        """),
    "GL004": ("""
        from ..ops.cuda_build import load_library
        from ..ops.operators import OperatorSet

        def run(xs):
            for x in xs:
                lib = load_library("program_eval.cu")
                ops = OperatorSet(["+"], [])
            return lib, ops
        """, """
        from ..ops.cuda_build import load_library
        from ..ops.operators import OperatorSet

        def run(xs):
            lib = load_library("program_eval.cu")
            ops = OperatorSet(["+"], [])
            return [x for x in xs], lib, ops
        """),
    "GL005": ("""
        import torch

        def grad_of(x):
            x = x.detach().requires_grad_(True)
            y = torch.exp(x)
            x.add_(1.0)
            (g,) = torch.autograd.grad(y.sum(), x)
            return g
        """, """
        import torch

        def grad_of(x):
            x = x.detach().requires_grad_(True)
            y = torch.exp(x)
            (g,) = torch.autograd.grad(y.sum(), x)
            g = g.clone()
            return g
        """),
}


@pytest.mark.parametrize("rid", sorted(HAZARDS))
def test_restated_rule_flags_hazard_and_not_clean(rid):
    bad, good = HAZARDS[rid]
    assert rid in _ids(_lint(bad))
    assert rid not in _ids(_lint(good))


def test_gl003_hot_loop_sync_in_step_and_mutation_only():
    """GL003: a host read of a tensor in evolve/step.py or mutation.py
    (every function, and what they call) is flagged; a read of a host value
    there, and the same sync elsewhere, are not."""
    bad = """
        import torch

        def helper(x):
            return x.item()

        def generation_step(x, cfg):
            n = int(torch.sum(x > 0))
            return helper(x) + n
        """
    good = """
        import math

        def generation_step(x, cfg):
            k = int(cfg.staged_sample_rows)
            r = int(math.ceil(len(x) * 0.5))
            return x[:k + r]
        """
    assert "GL003" in _ids(_lint(bad, "pkg/evolve/step.py"))
    assert len([f for f in _lint(bad, "pkg/evolve/mutation.py") if f.rule_id == "GL003"]) == 2
    assert "GL003" not in _ids(_lint(good, "pkg/evolve/step.py"))
    assert "GL003" not in _ids(_lint(bad, "pkg/evolve/engine.py"))
    marked = "# graftlint: hot-loop\n" + textwrap.dedent(bad)
    assert "GL003" in _ids(_lint(marked, "pkg/ops/mod.py"))


def test_gl002_out_of_scope_and_suppression():
    src = """
        import numpy as np

        def f():
            return np.random.normal()
        """
    assert "GL002" not in _ids(_lint(src, "pkg/serve/mod.py"))
    sup = src.replace("np.random.normal()", "np.random.normal()  # graftlint: disable=GL002")
    assert "GL002" not in _ids(_lint(sup))


def test_numpy_generator_named_rng_is_not_a_key():
    src = """
        import numpy as np

        def f():
            rng = np.random.default_rng(0)
            return rng.normal(size=3), rng.normal(size=3)
        """
    assert "GL001" not in _ids(_lint(src, "pkg/bench/mod.py"))


# ---------------------------------------------------------------------------
# The tree, the CLI, the manifest, the imports
# ---------------------------------------------------------------------------


def test_port_tree_is_lint_clean():
    findings = SL.lint_paths([str(PORT)])
    assert findings == [], "\n".join(str(f) for f in findings)


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "evolve" / "m.py"
    bad.parent.mkdir()
    bad.write_text("import numpy as np\nx = np.random.rand()\n")
    assert lint_main([str(bad)]) == 1
    assert "GL002" in capsys.readouterr().out
    (tmp_path / "clean.py").write_text("x = 1\n")
    assert lint_main([str(tmp_path / "clean.py")]) == 0
    assert lint_main(["--select", "GL999", str(tmp_path)]) == 2
    assert lint_main(["--list-rules"]) == 0
    proc = subprocess.run([sys.executable, "-m", "symbolicregression_jl_tpu_torch.lint"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_manifest_acyclic_and_names_the_port_locks():
    SLO.check_manifest_acyclic()
    with pytest.raises(ValueError, match="cycle"):
        SLO.check_manifest_acyclic(list(SLO.BLESSED_EDGES)
                                   + [("cuda_build._LOCK", "_ProgramKernel._lock")])
    # the JAX package's edges are all kept
    from symbolicregression_jl_tpu.lint import lock_order as JLO

    assert set(JLO.BLESSED_EDGES) <= set(SLO.BLESSED_EDGES)
    for name in ("_ProgramKernel._lock", "cuda_build._LOCK", "fused_eval._BF16_LOCK",
                 "fused_eval._WEIGHTED_LOCK"):
        assert name in SLO.MANIFEST_LOCKS
    assert SLO.violates("cuda_build._LOCK", "_ProgramKernel._lock")


def test_no_port_module_imports_jax():
    """Statically, no file of the port imports jax or the JAX package; and a
    fresh interpreter that imports every module of the port has loaded
    neither."""
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "symbolicregression_jl_tpu"), \
                    f"{path}: imports {n}"
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import symbolicregression_jl_tpu_torch as P\n"
        "mods = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.')\n"
        "        if not m.name.endswith('__main__')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(json.dumps([len(mods), sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'jaxlib', 'symbolicregression_jl_tpu'))]))\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    n, loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert n > 100 and loaded == []


# ---------------------------------------------------------------------------
# validate_programs and the engine's debug_checks
# ---------------------------------------------------------------------------


def _corruptions():
    """A valid [6, 8] table (the JAX package's encoding of six trees) and
    one corrupted copy per invariant."""
    import symbolicregression_jl_tpu as J
    from symbolicregression_jl_tpu.ops.encoding import encode_population

    ops = J.OperatorSet(["+", "*", "-"], ["cos"])
    trees = [J.parse_expression(s, ops) for s in
             ["x1 + 2.0", "cos(x2) * x1", "x1", "(x1 - 1.5) * cos(x2)", "3.0", "cos(cos(x1))"]]
    b = encode_population(trees, 8, ops)
    base = {f: np.array(getattr(b, f)) for f in ("arity", "op", "feat", "const", "length")}
    cases = {"clean": {}}

    def case(name, **edits):
        cases[name] = edits

    a = base["arity"].copy(); a[0, 1] = 3
    case("arity", arity=a)
    o = base["op"].copy(); o[1, 2] = 7
    case("op_range", op=o)
    ln = base["length"].copy(); ln[2] = 0; ln[3] = 99
    case("length", length=ln)
    a = base["arity"].copy(); a[0, 7] = 1
    case("padding", arity=a)
    a = base["arity"].copy(); a[3, 1] = 2
    case("underflow", arity=a)
    a = base["arity"].copy(); a[1, 0] = 1; a[1, 1] = 0
    case("stack", arity=a)
    f = base["feat"].copy(); f[0, 0] = 9
    case("feat", feat=f)
    o = base["op"].copy(); o[2, 0] = 5
    case("leaf_op", op=o)
    return ops, base, cases


@pytest.mark.parametrize("name", ["clean", "arity", "op_range", "length", "padding",
                                  "underflow", "stack", "feat", "leaf_op"])
def test_validate_programs_same_messages_as_jax(name):
    from symbolicregression_jl_tpu.ops.encoding import TreeBatch as JTB
    from symbolicregression_jl_tpu_torch.ops.encoding import TreeBatch as STB
    import symbolicregression_jl_tpu_torch as S

    jops, base, cases = _corruptions()
    fields = dict(base, **cases[name])
    sops = S.OperatorSet(["+", "*", "-"], ["cos"])
    jb = JTB(**{k: jax.numpy.asarray(v) for k, v in fields.items()})
    sb = STB(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in fields.items()})
    for strict in (False, True):
        jm = JR.check_programs(jb, jops, nfeatures=2, n_params=0, strict_padding=strict)
        sm = SR.check_programs(sb, sops, nfeatures=2, n_params=0, strict_padding=strict)
        assert sm == jm
    assert bool(jm) == (name != "clean")
    if name == "clean":
        assert SR.validate_programs(sb, sops) == JR.validate_programs(jb, jops) == 6
    else:
        with pytest.raises(JR.ProgramInvariantError) as je:
            JR.validate_programs(jb, jops, nfeatures=2, where="w")
        with pytest.raises(SR.ProgramInvariantError) as se:
            SR.validate_programs(sb, sops, nfeatures=2, where="w")
        assert str(se.value) == str(je.value)


def _engines(debug):
    import symbolicregression_jl_tpu as J
    import symbolicregression_jl_tpu_torch as S
    from symbolicregression_jl_tpu.evolve.engine import Engine as JEngine

    kw = dict(binary_operators=["+", "*"], unary_operators=["cos"], maxsize=10,
              populations=2, population_size=12, ncycles_per_iteration=2,
              tournament_selection_n=4, should_optimize_constants=False,
              save_to_file=False, debug_checks=debug)
    return (JEngine(J.Options(**kw), 2), S.Engine(S.Options(**kw), 2, device="cpu"))


def _corrupt(trees):
    """A stray operator arity in the last (padding) slot of every member:
    the trees still evaluate, their structure derivations are garbage, and
    the members an iteration leaves unchanged carry it on."""
    a = np.array(trees.arity)
    a[..., -1] = np.where(np.array(trees.length) < a.shape[-1], 2, a[..., -1])
    return a


def test_debug_checks_engine_raises_where_jax_raises():
    """init_state and run_iteration audit the population and the hall of
    fame with debug_checks=True, in both packages; the same corrupted state
    passes silently with the flag off (what the port always did before)."""
    from symbolicregression_jl_tpu.core.dataset import make_dataset as j_make
    from symbolicregression_jl_tpu_torch.core.dataset import make_dataset as s_make

    X = np.random.default_rng(0).normal(size=(64, 2)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=64).astype(np.float32)
    jd, sd = j_make(X, y).data, s_make(X, y, device="cpu").data
    outcomes = {}
    for debug in (False, True):
        je, se = _engines(debug)
        js = je.init_state(jax.random.key(0), jd, 2)
        ss = se.init_state(torch.tensor([0, 0], dtype=torch.int32), sd, 2)
        jbad = dataclasses.replace(js, pops=dataclasses.replace(
            js.pops, trees=dataclasses.replace(js.pops.trees,
                                               arity=jax.numpy.asarray(_corrupt(js.pops.trees)))))
        sbad = dataclasses.replace(ss, pops=dataclasses.replace(
            ss.pops, trees=dataclasses.replace(ss.pops.trees,
                                               arity=torch.from_numpy(_corrupt(ss.pops.trees)))))
        res = []
        for eng, st, data in ((je, jbad, jd), (se, sbad, sd)):
            try:
                eng.run_iteration(st, data, 10)
                res.append("ok")
            except AssertionError as e:
                res.append(str(e).splitlines()[0])
        outcomes[debug] = res
    assert outcomes[False] == ["ok", "ok"]
    assert outcomes[True][0] == outcomes[True][1] != "ok"
    assert "[engine run_iteration: " in outcomes[True][1]


def test_debug_checks_run_iteration_audits_every_iteration(monkeypatch):
    """With debug_checks the port's engine audits after init_state and
    after every run_iteration, chunked or not, as the JAX engine does."""
    from symbolicregression_jl_tpu_torch.core.dataset import make_dataset as s_make

    X = np.random.default_rng(0).normal(size=(48, 2)).astype(np.float32)
    sd = s_make(X, X[:, 0] * 2.0, device="cpu").data
    _, se = _engines(True)
    seen = []
    orig = se._audit_state
    monkeypatch.setattr(se, "_audit_state", lambda st, where: (seen.append(where), orig(st, where)))
    st = se.init_state(torch.tensor([0, 1], dtype=torch.int32), sd, 2)
    st = se.run_iteration(st, sd, 10)
    st = se.run_iteration(st, sd, 10, chunk_sizes=[1, 1])
    assert seen == ["init_state", "run_iteration", "run_iteration(chunked)"]
    # and a corrupted population makes the next iteration's audit raise
    a = st.pops.trees.arity.clone()
    a[:, :, -1] = 2
    bad = dataclasses.replace(st, pops=dataclasses.replace(
        st.pops, trees=dataclasses.replace(st.pops.trees, arity=a)))
    with pytest.raises(SR.ProgramInvariantError, match="nonzero arity in padding"):
        se._audit_state(bad, where="run_iteration")


def test_compile_count_guard_and_no_transfer_on_cpu():
    """compile_count_guard counts ops/cuda_build.py's build and load events;
    no_transfer is a no-op without CUDA."""
    from symbolicregression_jl_tpu_torch.ops import cuda_build

    with SR.compile_count_guard(0) as stats:
        pass
    assert (stats.traces, stats.backend_compiles) == (0, 0)
    with pytest.raises(SR.CompileBudgetExceeded):
        with SR.compile_count_guard(0, what="probe"):
            cuda_build._notify("build", "x.cu", 1.0)
            cuda_build._notify("load", "x.cu", 0.1)
    with SR.no_transfer():
        assert float(torch.ones(2).sum()) == 2.0
