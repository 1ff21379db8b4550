"""LLM-in-the-loop search: propose -> seed -> refine, with any proposer.

The fork's examples/custom_population_llm*.jl loop is: run some
iterations, show the pareto front to an LLM over an OpenAI-compatible
chat API, parse its proposed expressions, seed a fresh population, and
resume. The library hooks that make this work are exactly three
(``initial_population`` / ``guesses`` seeding, ``parse_expression``, and
warm starting via ``saved_state``), so this example factors the LLM
behind a plain callable: plug in any proposer (an HTTP client, a local
model, a heuristic) without changing the loop. The default proposer is
a heuristic and makes no network call.
"""

from typing import Callable, List, Sequence

import numpy as np

import symbolicregression_jl_tpu_torch as sr


def heuristic_proposer(pareto: Sequence, nvars: int) -> List[str]:
    """Stand-in for an LLM call: takes the current pareto front rows
    [(complexity, loss, equation_string)], returns new expression
    strings. A real deployment would format these into a prompt, send it
    to a chat API, then return the parsed reply lines."""
    props = []
    for _, _, eq in pareto[-2:]:
        # naive "creativity": perturb the best forms structurally
        props.append(f"({eq}) + 0.1 * x{nvars}")
        props.append(f"1.1 * ({eq})")
    return props or ["x1"]


def main(rounds: int = 3, niterations: int = 8, seed: int = 0, device=None,
         proposer: Callable[[Sequence, int], List[str]] = heuristic_proposer) -> None:
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (300, 2)).astype(np.float32)
    y = 2.0 * np.cos(2.3 * X[:, 0]) - X[:, 1] ** 2

    options = sr.Options(
        binary_operators=["+", "-", "*"],
        unary_operators=["cos"],
        maxsize=16,
        populations=8,
        population_size=25,
        ncycles_per_iteration=80,
        save_to_file=False,
    )

    state = None
    guesses = None
    for r in range(rounds):
        state, hof = sr.equation_search(
            X, y,
            options=options,
            niterations=niterations,
            saved_state=state,
            guesses=guesses,
            return_state=True,
            seed=seed + r,
            verbosity=0,
            device=device,
        )
        front = [(e.complexity, e.loss, e.equation_string())
                 for e in hof.pareto_frontier()]
        best = min(e.loss for e in hof.pareto_frontier())
        print(f"round {r}: best loss {best:.4g}, front size {len(front)}")
        # the "LLM" sees the front and proposes the next seeds
        guesses = proposer(front, 2)

    print("final best:", min(e.loss for e in hof.pareto_frontier()))


if __name__ == "__main__":
    main()
