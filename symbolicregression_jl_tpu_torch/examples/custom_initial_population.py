"""Seed the search with a custom initial population.

Mirrors the fork's examples/custom_initial_population.jl: build
expressions yourself (domain knowledge, a previous run, or any external
generator), parse them, and hand them to ``equation_search`` via
``initial_population``. Seeds fill the initial islands (tiled if fewer
than islands x population_size); the search refines them.

``guesses=`` is the lighter-weight variant: guesses are evaluated,
optimized, and injected into the starting hall of fame.
"""

import numpy as np

import symbolicregression_jl_tpu_torch as sr


def main(niterations: int = 6, seed: int = 0, device=None) -> None:
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (300, 2)).astype(np.float32)
    y = 1.8 * np.cos(2.0 * X[:, 0]) + 0.5 * X[:, 1]

    options = sr.Options(
        binary_operators=["+", "-", "*"],
        unary_operators=["cos"],
        maxsize=16,
        populations=6,
        population_size=25,
        ncycles_per_iteration=60,
        save_to_file=False,
    )

    # Hand-built starting points, e.g. near-miss forms from theory.
    seeds = [
        "1.0 * cos(x1) + x2",
        "cos(2.0 * x1)",
        "x1 + x2",
    ]

    hof = sr.equation_search(
        X, y,
        options=options,
        niterations=niterations,
        initial_population=seeds,
        guesses=["2.0 * cos(2.0 * x1) + 0.5 * x2"],
        seed=seed,
        verbosity=0,
        device=device,
    )
    for e in hof.pareto_frontier():
        print(f"  {e.complexity:3d}  {e.loss:10.4g}  {e.equation_string()}")


if __name__ == "__main__":
    main()
