"""equation_search over a torch.distributed group of gloo CPU ranks.

- Data-row shards (``RuntimeOptions(n_data_shards=2)``) against one data
  shard: equal complexities and losses within rtol 1e-4, as the JAX
  package's tests/test_data_sharding.py holds its row-sharded search (the
  row partials are added in another order).
- A SIGTERM to one rank stops every rank at the next boundary with its
  checkpoint block (``search_state.pkl.rank{k}``); ``resume="auto"`` from
  the rank files ends bit-identical to the uninterrupted 2-rank run (the
  device evaluation counter restarts on resume; the totals are equal).
- Rank 0 alone writes the CSVs; a defaulted run_id becomes
  ``multihost_seed{seed}``; every rank returns the same full state.
"""

import dataclasses
import os

import numpy as np
import pytest

import symbolicregression_jl_tpu_torch as srt
from symbolicregression_jl_tpu_torch.api.checkpoint import map_arrays
from symbolicregression_jl_tpu_torch.api.search import RuntimeOptions
from symbolicregression_jl_tpu_torch.parallel.launch import run_ranks

from torch_parity import problem

TESTS = os.path.dirname(os.path.abspath(__file__))


def _ranks(tmp_path, n, name, **kw):
    return run_ranks("torch_mesh_workers:search", n, kwargs=kw, sys_path=[TESTS],
                     timeout_s=110, workdir=str(tmp_path / name))


def _bits_equal(a, b) -> bool:
    la, lb = [], []
    map_arrays(a, la.append)
    map_arrays(b, lb.append)
    bits = lambda x: np.ascontiguousarray(x).reshape(-1).view(np.uint8)
    return len(la) == len(lb) and all(np.array_equal(bits(x), bits(y)) for x, y in zip(la, lb))


def test_data_row_shards_match_one_shard(tmp_path):
    rng = np.random.default_rng(5)
    X = rng.uniform(-2, 2, (128, 3)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + 0.5 * X[:, 2]).astype(np.float32)
    kw = dict(binary_operators=["+", "*"], unary_operators=[], maxsize=6, populations=2,
              population_size=10, tournament_selection_n=4, ncycles_per_iteration=2,
              save_to_file=False)
    one = _ranks(tmp_path, 1, "one", X=X, y=y, options_kw=kw, niterations=2, seed=9)
    two = _ranks(tmp_path, 2, "two", X=X, y=y, options_kw=kw, niterations=2, seed=9,
                 runtime_kw={"n_data_shards": 2},
                 refused_kw={"n_data_shards": 2, "mesh_runtime": True})
    a = sorted((c, loss) for c, loss, _ in one[0]["hof"])
    b = sorted((c, loss) for c, loss, _ in two[0]["hof"])
    assert [c for c, _ in a] == [c for c, _ in b]
    np.testing.assert_allclose([v for _, v in a], [v for _, v in b], rtol=1e-4)
    assert two[0]["hof"] == two[1]["hof"]
    # JAX's refusal, word for word, on every rank
    for r in two:
        assert r["refusal"].startswith("mesh_runtime shards the island axis only; data-row "
                                       "sharding (n_data_shards > 1) stays on the legacy")


def test_sigterm_one_rank_then_resume_bit_identical(tmp_path):
    X, y = problem(0)
    out = str(tmp_path / "out")
    kw = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=10,
              populations=4, population_size=16, ncycles_per_iteration=3,
              tournament_selection_n=8, output_directory=out, turbo=True)
    run = dict(X=X, y=y, options_kw=kw, niterations=3, seed=0)
    whole = _ranks(tmp_path, 2, "whole", run_id="whole", **run)
    files = sorted(os.listdir(os.path.join(out, "whole")))
    assert "search_state.pkl.rank0" in files and "search_state.pkl.rank1" in files
    assert "search_state.pkl" not in files and "hall_of_fame.csv" in files
    assert _bits_equal(whole[0]["state"], whole[1]["state"])

    killed = _ranks(tmp_path, 2, "killed", run_id="b", sigterm_rank=1, **run)
    assert [k["iterations_done"] for k in killed] == [2, 2]
    resumed = _ranks(tmp_path, 2, "resumed", run_id="b", resume="auto", **run)
    strip = lambda st: dataclasses.replace(st, num_evals=None)   # restarts at 0 on resume
    for r in resumed:
        assert r["iterations_done"] == 3
        assert _bits_equal(strip(whole[0]["state"]), strip(r["state"]))
        assert r["num_evals"] == whole[0]["num_evals"]
        assert r["hof"] == whole[0]["hof"]
    # the rank set reassembles into the full state in one process too
    state = srt.api.checkpoint.load_search_state(
        os.path.join(out, "b", "search_state.pkl"), srt.Options(**kw), device="cpu")
    assert state.iterations_done == 3 and state.device_states[0].birth.shape == (4,)


def test_default_run_id_and_rank0_outputs(tmp_path):
    X, y = problem(1)
    out = str(tmp_path / "out")
    kw = dict(binary_operators=["+", "*"], unary_operators=[], maxsize=6, populations=2,
              population_size=10, tournament_selection_n=4, ncycles_per_iteration=2,
              output_directory=out, telemetry=True)
    res = _ranks(tmp_path, 2, "ids", X=X, y=y, options_kw=kw, niterations=1, seed=4,
                 runtime_kw={"mesh_runtime": True, "mesh_exchange_every": 1})
    assert os.listdir(out) == ["multihost_seed4"] and res[0]["hof"] == res[1]["hof"]
    files = sorted(os.listdir(os.path.join(out, "multihost_seed4")))
    assert files.count("telemetry.jsonl") == 1 and "search_state.pkl.rank1" in files
    import json

    with open(os.path.join(out, "multihost_seed4", "telemetry.jsonl")) as f:
        events = [json.loads(line) for line in f]
    start = next(e for e in events if e["event"] == "run_start")
    assert start["n_devices"] == 2
    mesh = [e for e in events if e["event"] == "mesh"]
    assert mesh and mesh[0]["shards"] == 2
    d = mesh[0]["detail"]
    assert d["rows"] == d["shard_unique"] + d["local_dup"]
    assert d["shard_unique"] >= d["global_unique"]


def test_runtime_options_without_a_group():
    X, y = problem(2)
    o = srt.Options(binary_operators=["+", "*"], unary_operators=[], maxsize=6, populations=2,
                    population_size=10, tournament_selection_n=4, ncycles_per_iteration=2,
                    save_to_file=False)
    # a 1-rank mesh with no process group: the mesh runtime on one device
    hof = srt.equation_search(X, y, options=o, device="cpu", verbosity=0, seed=0,
                              runtime_options=RuntimeOptions(niterations=1, mesh_runtime=True,
                                                             mesh_dedup=False,
                                                             mesh_exchange_every=2))
    assert hof.entries
    with pytest.raises(ValueError, match=r"mesh shape 1x2 != 1 devices"):
        srt.equation_search(X, y, options=o, device="cpu", verbosity=0, seed=0,
                            runtime_options=RuntimeOptions(niterations=1, n_data_shards=2))
    with pytest.raises(ValueError, match="in no torch.distributed group"):
        srt.equation_search(X, y, options=o, device="cpu", verbosity=0, seed=0,
                            runtime_options=RuntimeOptions(niterations=1, devices=[0, 1]))
    with pytest.raises(ValueError, match=r"mesh shape 1x2 != 1 devices"):
        srt.SRRegressor(niterations=1, device="cpu", n_data_shards=2, binary_operators=["+"],
                        populations=2, population_size=10, tournament_selection_n=4,
                        save_to_file=False).fit(X, y)
