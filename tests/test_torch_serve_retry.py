"""A served request whose iteration runs out of device memory part-way is
retried whole by graftshield: one more pass of the constant optimizer (a
whole iteration's launches again), the same result bit for bit, and a
``retry`` fault in the request's flight-recorder bundle. This is what
``chip_smoke.py`` phase 32's launch rule counts: four tenants of the
optimizer cell sharing one card can exhaust its memory at 5 cycles."""

import json
import os

import numpy as np
import torch

from symbolicregression_jl_tpu_torch.evolve.engine import Engine
from symbolicregression_jl_tpu_torch.pack import PackPolicy
from symbolicregression_jl_tpu_torch.serve import SearchServer

import torch_parity  # noqa: F401  (caps torch's threads per worker)

OPTIONS = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=10,
               populations=2, population_size=16, tournament_selection_n=4,
               ncycles_per_iteration=5, turbo=True)


def _serve(root, monkeypatch, fail_at=None):
    calls = []
    orig = Engine._optimize

    def optimize(self, *a, **k):
        calls.append(1)
        if len(calls) == fail_at:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return orig(self, *a, **k)

    monkeypatch.setattr(Engine, "_optimize", optimize)
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (200, 2)).astype(np.float32)
    y = (np.cos(X[:, 0]) + X[:, 1]).astype(np.float32)
    server = SearchServer(str(root), pack=PackPolicy(), device="cpu")
    rid = server.submit(X, y, options=OPTIONS, niterations=2, seed=3)
    server.start()
    snap = server.wait(rid, timeout=300)
    server.stop(drain=True, timeout=60)
    bundle = os.path.join(str(root), "requests", rid, rid, "pulse_bundle.json")
    events = json.load(open(bundle))["events"] if os.path.exists(bundle) else []
    retries = [e for e in events if e.get("event") == "fault" and e.get("kind") == "retry"]
    return snap, len(calls), retries


def test_out_of_memory_mid_iteration_retries_the_iteration(tmp_path, monkeypatch):
    clean, n_clean, r_clean = _serve(tmp_path / "clean", monkeypatch)
    hit, n_hit, r_hit = _serve(tmp_path / "hit", monkeypatch, fail_at=2)
    assert clean["state"] == hit["state"] == "done"
    assert (n_clean, len(r_clean)) == (2, 0)
    assert n_hit == 3 and len(r_hit) == 1         # the second iteration ran twice
    assert hit["result"]["fingerprint"] == clean["result"]["fingerprint"]
