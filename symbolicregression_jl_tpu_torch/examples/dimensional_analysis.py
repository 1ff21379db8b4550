"""Dimensional analysis: search with SI units enforced.

Mirrors the reference's units feature (src/DimensionalAnalysis.jl): X/y
carry physical units; candidates whose dimensions cannot be made
consistent pay ``dimensional_constraint_penalty``, steering the search
toward physically meaningful laws. Here: Newtonian gravity
F = G*m1*m2/r^2 from noisy measurements.
"""

import numpy as np

import symbolicregression_jl_tpu_torch as sr


def main(niterations: int = 16, seed: int = 0, device=None) -> None:
    rng = np.random.default_rng(seed)
    n = 400
    m1 = rng.uniform(1.0, 5.0, n).astype(np.float32)
    m2 = rng.uniform(1.0, 5.0, n).astype(np.float32)
    r = rng.uniform(0.5, 2.0, n).astype(np.float32)
    G = 6.674e-2  # rescaled for conditioning
    F = G * m1 * m2 / r**2

    X = np.stack([m1, m2, r], axis=1)
    model = sr.SRRegressor(
        niterations=niterations,
        binary_operators=["+", "-", "*", "/"],
        unary_operators=["square"],
        populations=12,
        population_size=33,
        ncycles_per_iteration=80,
        maxsize=12,
        dimensional_constraint_penalty=1000.0,
        save_to_file=False,
        device=device,
    )
    model.fit(X, F, X_units=["kg", "kg", "m"], y_units="kg*m/s^2")

    best = model.equations_[model.best_idx_]
    print("best dimensionally-consistent law:", best.equation)
    print("loss:", best.loss)


if __name__ == "__main__":
    main()
