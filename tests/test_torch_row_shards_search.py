"""``equation_search`` with ``RuntimeOptions(n_data_shards=2)`` on 2 gloo CPU
ranks, for each feature the port used to refuse under data-row shards: a
template expression, a custom whole-prediction ``loss_function``,
``batching`` and ``staged_eval``, and a user elementwise loss on the
user-loss route (``turbo`` on: the kernels' plain versions). Each runs
against the same search on one shard: every rank ends with the same hall
of fame, every loss is finite, and the losses at equal complexities agree
within rtol 1e-4, as the JAX package's tests/test_data_sharding.py holds
its row-sharded search (the row sums are added in another order).
"""

import os

import numpy as np
import pytest

import symbolicregression_jl_tpu_torch as srt
from symbolicregression_jl_tpu_torch.parallel.launch import run_ranks

import torch_row_shard_workers as W

TESTS = os.path.dirname(os.path.abspath(__file__))


def _problem():
    rng = np.random.default_rng(5)
    X = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + 0.5 * X[:, 2]).astype(np.float32)
    return X, y


@pytest.mark.parametrize("feature", ["template", "loss", "batching", "staged", "user_loss"])
def test_search_on_two_row_shards_matches_one(feature, tmp_path):
    X, y = _problem()
    one = srt.equation_search(X, y, options=W.feature_options(feature), niterations=2, seed=3,
                              device="cpu", verbosity=0)
    ranks = run_ranks("torch_row_shard_workers:search_feature", 2, kwargs=dict(
        X=X, y=y, feature=feature, niterations=2, seed=3, n_data_shards=2),
        sys_path=[TESTS], timeout_s=110, workdir=str(tmp_path / "ranks"))
    assert ranks[0]["hof"] == ranks[1]["hof"] and ranks[0]["digest"] == ranks[1]["digest"]
    a = sorted((e.complexity, float(e.loss)) for e in one.entries)
    b = sorted((c, loss) for c, loss, _ in ranks[0]["hof"])
    assert np.isfinite([v for _, v in b]).all()
    assert [c for c, _ in a] == [c for c, _ in b]
    np.testing.assert_allclose([v for _, v in a], [v for _, v in b], rtol=1e-4)
