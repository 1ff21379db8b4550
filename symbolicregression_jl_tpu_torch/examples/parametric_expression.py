"""Parametric expressions: one functional form, per-class constants.

Mirrors the reference's examples/parameterized_function.jl: every data
class shares the evolved structure, but each class fits its own
parameter values (here: a per-class amplitude on the cosine term). The
per-class parameter banks ride the interpreter kernel's parametric form
and are optimized jointly with the expression constants.
"""

import numpy as np

import symbolicregression_jl_tpu_torch as sr


def main(niterations: int = 12, seed: int = 0, device=None) -> None:
    rng = np.random.default_rng(seed)
    n = 600
    X = rng.uniform(-2.0, 2.0, (n, 2)).astype(np.float32)
    category = rng.integers(0, 3, n)
    amp = np.array([1.0, 2.0, 3.0], np.float32)[category]
    y = amp * np.cos(X[:, 0]) + X[:, 1]

    model = sr.SRRegressor(
        niterations=niterations,
        binary_operators=["+", "-", "*"],
        unary_operators=["cos"],
        expression_spec=sr.ParametricExpressionSpec(max_parameters=1),
        populations=8,
        population_size=33,
        ncycles_per_iteration=80,
        maxsize=12,
        save_to_file=False,
        device=device,
    )
    model.fit(X, y, category=category)

    best = model.equations_[model.best_idx_]
    print("best parametric form:", best.equation)
    print("loss:", best.loss)
    # Per-class fitted parameter banks, shape (n_params, n_classes):
    # the amplitude parameter should recover ~[1, 2, 3] per class.
    print("fitted per-class parameters:")
    print(np.round(best.params, 3))


if __name__ == "__main__":
    main()
