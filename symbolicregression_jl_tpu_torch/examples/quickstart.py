"""Quickstart: fit a symbolic expression with the sklearn-style API.

Mirrors the reference's README quickstart (SRRegressor via MLJ). On a
CUDA device, ``device_scale="auto"`` (the default) picks the card's
search scale when none of its options is set; this example pins a small
scale, as the JAX package's does.
"""

import numpy as np

import symbolicregression_jl_tpu_torch as sr


def main(niterations: int = 10, seed: int = 0, device=None) -> None:
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3.0, 3.0, (500, 2)).astype(np.float32)
    y = 2.0 * np.cos(2.3 * X[:, 0]) - X[:, 1] ** 2

    model = sr.SRRegressor(
        niterations=niterations,
        binary_operators=["+", "-", "*"],
        unary_operators=["cos"],
        # Small scale; drop these three lines on the card to get the
        # device-native 512x256 configuration.
        populations=8,
        population_size=33,
        ncycles_per_iteration=100,
        maxsize=20,
        save_to_file=False,
        device=device,
    )
    model.fit(X, y)

    print("best:", model.equations_[model.best_idx_].equation)
    print("pareto front (complexity, loss, equation):")
    for row in model.equations_:
        print(f"  {row.complexity:3d}  {row.loss:10.4g}  {row.equation}")

    y_hat = model.predict(X)
    print("train MSE:", float(np.mean((y_hat - y) ** 2)))


if __name__ == "__main__":
    main()
