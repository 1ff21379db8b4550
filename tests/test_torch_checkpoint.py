"""The port's checkpoints, resume and hall-of-fame CSVs.

Mirrors tests/test_checkpoint.py and tests/test_shield_checkpoint.py for
one process: round trips keep every tensor; truncated or bit-flipped
files raise CheckpointCorruptError and a missing one FileNotFoundError;
the rolling set keeps k and the loader falls back past corrupt files;
``resume="auto"`` finds the newest run and ends bit-identical to an
uninterrupted search. The CSVs are byte-equal to the JAX package's for
the same entries, and each package reads the other's. Everything runs on
the CPU at 2 islands x 12-16 members.
"""

import dataclasses
import os
import pickle

import jax
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.api import hall_of_fame as JH
from symbolicregression_jl_tpu.api import search as JA
from symbolicregression_jl_tpu.evolve.engine import Engine as JEngine
from symbolicregression_jl_tpu.models import ParametricExpressionSpec as JSpec
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.api import hall_of_fame as SH
from symbolicregression_jl_tpu_torch.api.checkpoint import (CheckpointCorruptError,
                                                            map_arrays, load_search_state,
                                                            options_fingerprint,
                                                            save_search_state)
from symbolicregression_jl_tpu_torch.shield.checkpoints import (RollingCheckpointer,
                                                                discover_resume_path,
                                                                load_newest_valid,
                                                                rolled_paths)

from torch_parity import cap_torch_threads

cap_torch_threads()


def _problem(n=128, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    y = (2.0 * X[:, 0] + X[:, 1] * X[:, 1]).astype(np.float32)
    return X, y


def _options(tmp_path, **kw):
    base = dict(binary_operators=["+", "-", "*"], unary_operators=[], maxsize=10,
                populations=2, population_size=12, tournament_selection_n=4,
                ncycles_per_iteration=4, save_to_file=True, output_directory=str(tmp_path))
    base.update(kw)
    return S.Options(**base)


def _tensors(state):
    out = []
    map_arrays(state, lambda t: out.append(t) or t)
    return out


def _truncate(path, keep_fraction):
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:int(len(data) * keep_fraction)])


def _flip(path, offset=-64):
    with open(path, "r+b") as f:
        f.seek(offset, os.SEEK_END if offset < 0 else os.SEEK_SET)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.fixture(scope="module")
def fitted_state(tmp_path_factory):
    """One small fitted SearchState shared by the file tests."""
    tmp = tmp_path_factory.mktemp("port_ckpt")
    options = _options(tmp, save_to_file=False)
    state, _ = S.equation_search(*_problem(), options=options, niterations=1, seed=3,
                                 verbosity=0, return_state=True, device="cpu")
    return state, options


def test_roundtrip_preserves_every_tensor(tmp_path, fitted_state):
    state, options = fitted_state
    p = str(tmp_path / "state.pkl")
    save_search_state(p, dataclasses.replace(state, iterations_done=7))
    loaded = load_search_state(p, options, device="cpu")
    assert loaded.iterations_done == 7 and loaded.num_evals == state.num_evals
    assert loaded.nfeatures == [2]
    a, b = _tensors(state.device_states[0]), _tensors(loaded.device_states[0])
    assert len(a) == len(b) > 20
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and y.device.type == "cpu" and torch.equal(x, y)


@pytest.mark.parametrize("keep_fraction", [0.0, 0.1, 0.5, 0.95])
def test_truncated_checkpoint_raises_corrupt(tmp_path, fitted_state, keep_fraction):
    state, options = fitted_state
    p = str(tmp_path / "state.pkl")
    save_search_state(p, state)
    _truncate(p, keep_fraction)
    with pytest.raises(CheckpointCorruptError):
        load_search_state(p, options, device="cpu")


@pytest.mark.parametrize("offset", [-64, -1024, 64, 200])
def test_flipped_byte_fails_digest(tmp_path, fitted_state, offset):
    state, options = fitted_state
    p = str(tmp_path / "state.pkl")
    save_search_state(p, state)
    _flip(p, offset)
    with pytest.raises(CheckpointCorruptError):
        load_search_state(p, options, device="cpu")


def test_stale_format_and_non_dict_raise_corrupt(tmp_path, fitted_state):
    _, options = fitted_state
    p = str(tmp_path / "state.pkl")
    with open(p, "wb") as f:
        pickle.dump({"format_version": 99, "compat": {}}, f)
    with pytest.raises(CheckpointCorruptError, match="format_version"):
        load_search_state(p, options, device="cpu")
    with open(p, "wb") as f:
        pickle.dump([1, 2, 3], f)
    with pytest.raises(CheckpointCorruptError):
        load_search_state(p, options, device="cpu")


def test_missing_file_is_not_corrupt(tmp_path, fitted_state):
    _, options = fitted_state
    with pytest.raises(FileNotFoundError):
        load_search_state(str(tmp_path / "nope.pkl"), options, device="cpu")


def test_rolling_keeps_last_k_and_falls_back_past_corruption(tmp_path, fitted_state):
    state, options = fitted_state
    base = str(tmp_path / "search_state.pkl")
    ck = RollingCheckpointer(base, keep=3)
    for n in range(5):
        ck.save(dataclasses.replace(state, iterations_done=n))
    paths = rolled_paths(base, 3)
    assert all(os.path.exists(p) for p in paths) and not os.path.exists(base + ".3")
    assert [load_search_state(p, options, device="cpu").iterations_done
            for p in paths] == [4, 3, 2]
    _flip(base)
    _truncate(base + ".1", 0.2)
    log = []
    with pytest.warns(UserWarning, match="corrupt"):
        loaded, used = load_newest_valid(paths, options, device="cpu", corrupt_log=log)
    assert used == base + ".2" and loaded.iterations_done == 2 and len(log) == 2
    _flip(base + ".2")
    with pytest.warns(UserWarning, match="corrupt"):
        with pytest.raises(CheckpointCorruptError, match="all 3"):
            load_newest_valid(paths, options, device="cpu")


def test_discover_resume_path_picks_newest_run(tmp_path, fitted_state):
    state, _ = fitted_state
    for run, stamp in (("run_a", 1), ("run_b", 2)):
        (tmp_path / run).mkdir()
        p = str(tmp_path / run / "search_state.pkl")
        save_search_state(p, state)
        os.utime(p, (stamp, stamp))
    cands = discover_resume_path(str(tmp_path))
    assert cands is not None and "run_b" in cands[0]
    assert discover_resume_path(str(tmp_path / "missing")) is None


def test_incompatible_options_and_feature_count_raise(tmp_path):
    X, y = _problem()
    options = _options(tmp_path)
    S.equation_search(X, y, options=options, niterations=1, seed=0, verbosity=0,
                      run_id="bad", device="cpu")
    ckpt = os.path.join(str(tmp_path), "bad", "search_state.pkl")
    with pytest.raises(ValueError, match="maxsize"):
        S.equation_search(X, y, options=_options(tmp_path, maxsize=16), saved_state=ckpt,
                          niterations=1, verbosity=0, device="cpu")
    with pytest.raises(ValueError, match="operators"):
        S.equation_search(X, y, options=_options(tmp_path, binary_operators=["+", "*", "/"]),
                          saved_state=ckpt, niterations=1, verbosity=0, device="cpu")
    X3 = np.concatenate([X, X[:, :1]], axis=1)
    with pytest.raises(ValueError, match="features"):
        S.equation_search(X3, y, options=options, saved_state=ckpt, niterations=1,
                          verbosity=0, device="cpu")


def test_resume_from_path_counts_evals_once(tmp_path):
    """A 2-iteration run equals a 1-iteration run continued from its
    checkpoint file for one more: the same total num_evals and hall of
    fame."""
    X, y = _problem()
    o = _options(tmp_path, save_to_file=False)
    s2, h2 = S.equation_search(X, y, options=o, niterations=2, seed=5, verbosity=0,
                               return_state=True, device="cpu")
    S.equation_search(X, y, options=_options(tmp_path), niterations=1, seed=5, verbosity=0,
                      run_id="one", device="cpu")
    sr, hr = S.equation_search(X, y, options=o, niterations=1, verbosity=0,
                               return_state=True, device="cpu",
                               saved_state=os.path.join(str(tmp_path), "one",
                                                        "search_state.pkl"))
    assert sr.num_evals == s2.num_evals
    assert [(e.loss, e.equation_string()) for e in hr.entries] == [
        (e.loss, e.equation_string()) for e in h2.entries]


def test_checkpoint_written_on_early_stop(tmp_path):
    """An early stop after iteration 1 (checkpoint_every_n=5 would skip it)
    still writes the final checkpoint."""
    X, y = _problem()
    options = _options(tmp_path, early_stop_condition=1e9)
    S.equation_search(X, y, options=options, device="cpu", runtime_options=S.RuntimeOptions(
        niterations=7, run_id="es", seed=0, verbosity=0, checkpoint_every_n=5))
    st = load_search_state(os.path.join(str(tmp_path), "es", "search_state.pkl"), options,
                           device="cpu")
    assert st.iterations_done == 1 and st.num_evals > 0


@pytest.mark.parametrize("batching", [False, True])
def test_resume_auto_is_bit_identical(tmp_path, batching):
    """niterations=3 straight through against niterations=2 and then
    resume="auto" to 3 under the same run_id: every state tensor bit-equal
    (the device evaluation counter restarts at 0 on resume, so it is
    compared as the total), the CSVs byte-equal. Corrupting the newest
    checkpoint falls back to the previous one and again ends bit-equal."""
    X, y = _problem()
    kw = dict(checkpoint_keep=3, batching=batching, batch_size=32)
    run = dict(seed=11, verbosity=0, run_id="r", device="cpu")
    sa, _ = S.equation_search(X, y, options=_options(tmp_path / "a", **kw), niterations=3,
                              return_state=True, **run)
    ob = _options(tmp_path / "b", **kw)
    S.equation_search(X, y, options=ob, niterations=2, runtime_options=S.RuntimeOptions(
        niterations=2, checkpoint_every_n=1, **{k: v for k, v in run.items()
                                                if k != "device"}), device="cpu")
    # ledger.jsonl: the cost account (RuntimeOptions(ledger=True), the default)
    assert sorted(os.listdir(tmp_path / "b" / "r")) == [
        "hall_of_fame.csv", "ledger.jsonl", "search_state.pkl", "search_state.pkl.1"]
    sb, _ = S.equation_search(X, y, options=ob, niterations=3, resume="auto",
                              return_state=True, **dict(run, seed=99))
    assert sb.iterations_done == 3 and sb.num_evals == sa.num_evals

    def check(s):
        ta, tb = _tensors(sa.device_states[0]), _tensors(s.device_states[0])
        nev = sa.device_states[0].num_evals
        for x, z in zip(ta, tb):
            if x is not nev:
                assert torch.equal(x, z)
        with open(tmp_path / "a" / "r" / "hall_of_fame.csv", "rb") as f:
            want = f.read()
        with open(tmp_path / "b" / "r" / "hall_of_fame.csv", "rb") as f:
            assert f.read() == want

    check(sb)
    # Corrupt the newest (iteration 3): resume falls back to iteration 2's.
    _flip(str(tmp_path / "b" / "r" / "search_state.pkl"))
    with pytest.warns(UserWarning, match="corrupt"):
        sc, _ = S.equation_search(X, y, options=ob, niterations=3, resume="auto",
                                  return_state=True, **run)
    check(sc)


def test_options_fingerprint_ignores_host_fields():
    a = S.Options(save_to_file=False)
    assert options_fingerprint(a) is not None
    assert options_fingerprint(a) == options_fingerprint(S.Options(output_directory="/x"))
    assert options_fingerprint(a) != options_fingerprint(S.Options(maxsize=21))


# ---------------------------------------------------------------------------
# Hall-of-fame CSVs against the JAX package
# ---------------------------------------------------------------------------


def _hofs(parametric: bool):
    """The same hall of fame decoded by both packages: the JAX package
    seeds guesses into a fresh state; the port decodes the converted
    state."""
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=12,
                populations=2, population_size=16, tournament_selection_n=4, turbo=False,
                save_to_file=False)
    rng = np.random.default_rng(4)
    X = rng.uniform(-2, 2, (64, 2)).astype(np.float32)
    cls = rng.integers(0, 3, 64)
    y = (X[:, 0] * np.array([1.0, 2.0, 3.0])[cls] + np.cos(X[:, 1])).astype(np.float32)
    extra = {"class": cls} if parametric else None
    if parametric:
        jo = J.Options(expression_spec=JSpec(max_parameters=1), **base)
        so = S.Options(expression_spec=S.ParametricExpressionSpec(max_parameters=1), **base)
        je = JEngine(jo, 2, n_params=1, n_classes=3)
        guesses = ["x1 * p1 + cos(x2)", "p1", "x1 * p1"]
    else:
        jo, so = J.Options(**base), S.Options(**base)
        je = JEngine(jo, 2)
        guesses = ["x1 * 1.5 + cos(x2)", "0.25", "x1 * x1 - 0.3333333", "cos(x2 * 2.0)"]
    jds = J.make_dataset(X, y, extra=extra)
    jds.update_baseline_loss(jo.elementwise_loss)
    js = je.init_state(jax.random.key(0), jds.data, 2)
    js = JA._seed_population(je, js, [J.parse_expression(g, jo.operators) for g in guesses],
                             jds.data, mode="replace_worst")
    jhof = JH.HallOfFame.from_device(jax.tree.map(np.asarray, js.hof), jo.operators)
    shof = SH.HallOfFame.from_device(interop.hof_state(jax.tree.map(np.asarray, js.hof),
                                                       device="cpu"), so.operators)
    return jo, so, jhof, shof


@pytest.mark.parametrize("parametric", [False, True])
def test_csv_byte_equal_and_cross_readable(tmp_path, parametric):
    jo, so, jhof, shof = _hofs(parametric)
    assert len(shof.entries) >= 3
    jp, sp = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    JH.save_hall_of_fame_csv(jp, jhof, jo.operators)
    SH.save_hall_of_fame_csv(sp, shof, so.operators)
    with open(jp, "rb") as f, open(sp, "rb") as g:
        assert f.read() == g.read()
    assert not os.path.exists(sp + ".bak")
    # Each package reads the other's file, parameters included.
    s_trees, s_params = SH.load_hall_of_fame_csv(jp, so.operators, return_params=True)
    j_trees, j_params = JH.load_hall_of_fame_csv(sp, jo.operators, return_params=True)
    assert [S.string_tree(t, precision=12) for t in s_trees] == [
        J.string_tree(t, precision=12) for t in j_trees] == [
        e.equation_string(precision=12) for e in shof.entries]
    for a, b, e in zip(s_params, j_params, shof.entries):
        if parametric:
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, e.params.ravel())
        else:
            assert a is None and b is None


def test_csv_guesses_round_trip_with_banks(tmp_path):
    """A parametric CSV's (expression, bank) pairs seed a new population as
    guesses: each seeded member carries its entry's bank."""
    from symbolicregression_jl_tpu_torch.api import search as SA
    from symbolicregression_jl_tpu_torch.evolve import rng as SR
    from symbolicregression_jl_tpu_torch.evolve.engine import Engine as SEngine

    _, so, _, shof = _hofs(True)
    p = str(tmp_path / "hof.csv")
    SH.save_hall_of_fame_csv(p, shof, so.operators)
    trees, params = SH.load_hall_of_fame_csv(p, so.operators, return_params=True)
    rng = np.random.default_rng(4)
    X = rng.uniform(-2, 2, (64, 2)).astype(np.float32)
    cls = rng.integers(0, 3, 64)
    ds = S.make_dataset(X, X[:, 0], extra={"class": cls}, device="cpu")
    ds.update_baseline_loss(so.elementwise_loss)
    se = SEngine(so, 2, device="cpu", n_params=1, n_classes=3)
    state = se.init_state(SR.key(0), ds.data, 2)
    out = SA._seed_population(se, state, trees, ds.data, mode="replace_worst", params=params)
    banks = out.pops.params[0].reshape(16, -1).numpy()
    for pr in params:
        assert any(np.array_equal(row, pr.astype(np.float32)) for row in banks)
