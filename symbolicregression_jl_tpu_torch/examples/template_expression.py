"""Template expressions: constrain the functional form, search the parts.

Mirrors the reference's examples/template_expression.jl: the model is
forced into the shape ``f(x1) * f(x1) + g(x2)``; the search only evolves
the subexpressions ``f`` and ``g``, and the combiner is fixed Python (run
once over every member, each call site one launch of the predict
kernel). Combiners may also differentiate subexpressions with ``sr.D``.
"""

import numpy as np

import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch.models import template_spec


def main(niterations: int = 8, seed: int = 0, device=None) -> None:
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (400, 2)).astype(np.float32)
    # truth: f(v) = 1.5*v, g(v) = cos(2v)  =>  y = f(x1)^2 + g(x2)
    y = (1.5 * X[:, 0]) ** 2 + np.cos(2.0 * X[:, 1])

    spec = template_spec(expressions=("f", "g"))(
        lambda f, g, x1, x2: f(x1) * f(x1) + g(x2)
    )

    model = sr.SRRegressor(
        niterations=niterations,
        binary_operators=["+", "-", "*"],
        unary_operators=["cos"],
        expression_spec=spec,
        populations=8,
        population_size=33,
        ncycles_per_iteration=60,
        maxsize=16,
        save_to_file=False,
        device=device,
    )
    model.fit(X, y)

    best = model.equations_[model.best_idx_]
    print("best template instance:")
    print(best.equation)
    print("loss:", best.loss)


if __name__ == "__main__":
    main()
