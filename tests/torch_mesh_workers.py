"""Rank functions of the multi-device tests (tests/test_torch_mesh_*.py).

Each runs in a process of its own, one rank of a gloo group that
``parallel/launch.run_ranks`` made, and imports no JAX: states come in
and go out as numpy trees (``api/checkpoint.map_arrays``).
"""

import numpy as np
import torch

import symbolicregression_jl_tpu_torch as srt
from symbolicregression_jl_tpu_torch.api.checkpoint import map_arrays
from symbolicregression_jl_tpu_torch.evolve import rng
from symbolicregression_jl_tpu_torch.evolve.engine import Engine
from symbolicregression_jl_tpu_torch.mesh import MeshEngine, MeshPlan

torch.set_num_threads(1)


def to_numpy(state):
    return map_arrays(state, lambda t: t.detach().cpu().numpy())


def to_torch(state):
    return map_arrays(state, lambda a: torch.from_numpy(np.array(a)))


def make_engine(options, nfeatures, plan=None, mesh_runtime=False, n_params=0, n_classes=0):
    if plan is None:
        return Engine(options, nfeatures, device="cpu", n_params=n_params, n_classes=n_classes)
    cls = MeshEngine if mesh_runtime else Engine
    kw = {} if mesh_runtime else {"plan": plan}
    args = (options, nfeatures, plan) if mesh_runtime else (options, nfeatures)
    return cls(*args, device="cpu", n_params=n_params, n_classes=n_classes, **kw)


def run_engine(X, y, options_kw, seed, niter, plan_kw=None, mesh_runtime=False, state=None,
               extra=None, telemetry=False):
    """``niter`` iterations of an engine (a mesh over every rank of the
    group with ``plan_kw``, else the plain Engine) from ``state`` (a full
    numpy state) or from init_state(seed). Returns the full final state as
    numpy (gathered) and, with ``telemetry``, each iteration's counters."""
    options = srt.Options(**options_kw)
    ds = srt.make_dataset(X, y, extra=extra, device="cpu")
    ds.update_baseline_loss(options.elementwise_loss)
    n_params = n_classes = 0
    if isinstance(options.expression_spec, srt.ParametricExpressionSpec):
        n_params, n_classes = options.expression_spec.max_parameters, ds.n_classes
    plan = MeshPlan.build(**plan_kw) if plan_kw is not None else None
    engine = make_engine(options, ds.nfeatures, plan, mesh_runtime, n_params, n_classes)
    data = plan.place_data(ds.data) if plan is not None else ds.data
    if state is None:
        st = engine.init_state(rng.key(seed), data, options.populations)
    else:
        st = to_torch(state)
        st = plan.place_state(st) if plan is not None else st
    telems = []
    for _ in range(niter):
        st = engine.run_iteration(st, data, options.maxsize)
        if telemetry:
            telems.append(to_numpy(st.telem))
    full = plan.gather_state(st) if plan is not None else st
    out = {"state": to_numpy(full), "telem": telems}
    if isinstance(engine, MeshEngine):
        out["exchange"] = engine.dedup_exchange(st)
    return out


def search(X, y, options_kw, niterations, seed, run_id=None, resume=None, runtime_kw=None,
           sigterm_rank=None, extra=None, refused_kw=None):
    """``equation_search`` on this rank (every rank of the group makes the
    same call). ``sigterm_rank`` sends that rank SIGTERM after its first
    iteration: the search stops "preempted" on every rank at the next
    boundary, each writing its checkpoint block. Returns the full state
    as numpy, the total evaluations, the iterations done and the hall of
    fame's (complexity, loss, equation) rows."""
    import os
    import signal

    from symbolicregression_jl_tpu_torch.api.search import RuntimeOptions
    from symbolicregression_jl_tpu_torch.parallel import multihost

    options = srt.Options(**options_kw)
    calls = []
    refusal = None
    if refused_kw is not None:
        # what the search refuses, it refuses on every rank alike
        try:
            srt.equation_search(X, y, options=options, device="cpu", verbosity=0, seed=seed,
                                runtime_options=RuntimeOptions(niterations=1, **refused_kw))
        except ValueError as e:
            refusal = str(e)

    def hook():
        calls.append(1)
        if len(calls) == 1 and multihost.process_index() == sigterm_rank:
            os.kill(os.getpid(), signal.SIGTERM)
        return None

    ropt = RuntimeOptions(niterations=niterations, seed=seed, verbosity=0,
                          stop_hook=hook if sigterm_rank is not None else None,
                          **(runtime_kw or {}))
    if run_id is not None:
        ropt.run_id = run_id
    state, hof = srt.equation_search(X, y, options=options, runtime_options=ropt,
                                     return_state=True, resume=resume, device="cpu",
                                     extra=extra)
    return {"state": to_numpy(state.device_states[0]), "num_evals": float(state.num_evals),
            "iterations_done": int(state.iterations_done), "refusal": refusal,
            "rank": multihost.process_index(),
            "hof": [(e.complexity, float(e.loss), e.equation_string()) for e in hof.entries]}
