"""Multi-device search: shard the island axis over the ranks of a
``torch.distributed`` group.

Every rank runs the same ``equation_search``; the islands split over the
ranks (``RuntimeOptions(devices=...)``, the ranks), each rank drives its
own kernel launches on its islands, and the hall-of-fame merge and the
migration pool are gathered across ranks. This example starts the ranks
itself (``parallel/launch.run_ranks``): gloo ranks on the CPU, the
counterpart of the JAX package's virtual 8-device CPU mesh, and on the
card two gloo ranks sharing it (NCCL takes one rank per device) or,
with ``ranks=1``, a one-rank NCCL group. Rank 0's hall of fame is
printed; ``main`` returns every rank's, with the rank's kernel launches.
"""

import os
import tempfile

import numpy as np


def _options(sr):
    return sr.Options(
        binary_operators=["+", "-", "*"],
        unary_operators=["cos"],
        maxsize=12,
        populations=8,   # islands, split over the ranks
        population_size=16,
        ncycles_per_iteration=20,
        save_to_file=False,
    )


def rank_search(X, y, niterations: int, seed: int, device: str):
    """One rank's search (``run_ranks`` calls it in every rank)."""
    import symbolicregression_jl_tpu_torch as sr
    from symbolicregression_jl_tpu_torch.api.search import RuntimeOptions
    from symbolicregression_jl_tpu_torch.ops import fused_eval
    from symbolicregression_jl_tpu_torch.parallel import multihost

    ranks = list(range(multihost.process_count()))
    hof = sr.equation_search(
        X, y,
        options=_options(sr),
        niterations=niterations,
        runtime_options=RuntimeOptions(
            niterations=niterations, verbosity=0, seed=seed, devices=ranks,
        ),
        device=device,
    )
    return {"devices": [f"rank{r}:{device}" for r in ranks],
            "front": [(e.complexity, float(e.loss), e.equation_string())
                      for e in hof.pareto_frontier()],
            "launches": fused_eval.kernel_launches()}


def main(niterations: int = 3, seed: int = 0, device=None, ranks: int = 2,
         timeout_s: float = 600.0):
    from symbolicregression_jl_tpu_torch.device import resolve_device
    from symbolicregression_jl_tpu_torch.parallel.launch import run_ranks

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (256, 2)).astype(np.float32)
    y = np.cos(2.0 * X[:, 0]) + 0.5 * X[:, 1]

    backend = "nccl" if dev.type == "cuda" and ranks == 1 else "gloo"
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    # The ranks share the host's cores: each gets its share of threads
    # (every rank's default pool on every core oversubscribes them).
    threads = str(max(1, (os.cpu_count() or 1) // ranks))
    results = run_ranks(
        "symbolicregression_jl_tpu_torch.examples.multi_device:rank_search", ranks,
        kwargs=dict(X=X, y=y, niterations=niterations, seed=seed, device=str(dev)),
        backend=backend, timeout_s=timeout_s, sys_path=[root],
        workdir=tempfile.mkdtemp(prefix="sr_multi_device_"),
        env=dict(os.environ, OMP_NUM_THREADS=threads, MKL_NUM_THREADS=threads))
    print(f"devices: {results[0]['devices']} ({backend})")
    for c, loss, eq in results[0]["front"][-3:]:
        print(f"  {c:3d}  {loss:10.4g}  {eq}")
    return results   # each rank's devices, front and kernel launches


if __name__ == "__main__":
    main()
