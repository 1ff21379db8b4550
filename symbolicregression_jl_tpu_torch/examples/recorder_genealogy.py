"""Record the full mutation genealogy of a search.

Mirrors the reference's Recorder (src/Recorder.jl + JSON3 ext): with
``use_recorder=True`` every accepted mutation/crossover becomes an event
(kind, parents, child, the member that died, cost delta), and
``recorder_verbosity=2`` additionally records every rejected candidate
with its reason (constraint / invalid / annealing). The stream is
written as JSON at teardown; here we also reconstruct a lineage chain
from it.
"""

import json
import os
import tempfile

import numpy as np

import symbolicregression_jl_tpu_torch as sr


def main(niterations: int = 3, seed: int = 0, device=None) -> None:
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (200, 2)).astype(np.float32)
    y = np.cos(2.0 * X[:, 0]) + X[:, 1]

    rec_path = os.path.join(tempfile.mkdtemp(), "recorder.json")
    options = sr.Options(
        binary_operators=["+", "-", "*"],
        unary_operators=["cos"],
        maxsize=12,
        populations=4,
        population_size=16,
        ncycles_per_iteration=30,
        use_recorder=True,
        recorder_file=rec_path,
        save_to_file=False,
    )
    sr.equation_search(X, y, options=options, niterations=niterations,
                       seed=seed, verbosity=0, device=device)

    with open(rec_path) as f:
        record = json.load(f)
    events = [ev for it in record["iterations"]
              for ev in it["events"][0]["accepted"]]
    kinds = {}
    for ev in events:
        kinds[ev["type"]] = kinds.get(ev["type"], 0) + 1
    print(f"{len(events)} accepted events across "
          f"{len(record['iterations'])} iterations; by kind:")
    for k, c in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {k:24s} {c}")

    # walk one lineage: pick the last event and chase parents backwards
    # (a tiny run may accept nothing: say so instead of raising on
    # events[-1])
    if events:
        by_child = {ev["child"]: ev for ev in events}
        ev = events[-1]
        chain = []
        while ev is not None and len(chain) < 10:
            chain.append(ev)
            ev = by_child.get(ev["parent"])
        print("lineage of the last child (most recent first):")
        for ev in chain:
            print(f"  {ev['type']:20s} parent={ev['parent']} "
                  f"child={ev['child']} d_cost={ev['cost_delta']:+.3g}"
                  if isinstance(ev['cost_delta'], float) else ev)
    else:
        print("no accepted events in this run (try more iterations "
              "or larger populations); skipping the lineage walk")


if __name__ == "__main__":
    main()
