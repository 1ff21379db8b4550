"""Search genealogy recorder (a copy of the JAX package's ``utils/recorder.py``,
reading the port's tensors on the host).

The Recorder analogue (the reference's src/Recorder.jl +
ext/SymbolicRegressionJSON3Ext.jl): when ``options.use_recorder`` is set,
the search accumulates a JSON-serializable record of the run and writes it
to ``options.recorder_file`` at teardown
(src/SymbolicRegression.jl:1231).

Granularity: the reference logs every mutation/death event from its
sequential per-member loop (src/RegularizedEvolution.jl:47-149). Here the
whole generation runs as batched device ops over every island; per-event
host work would serialize the device, so the generation step instead emits
`CycleEvents` — int32/f32 side arrays (kind, parent/child/died refs,
accept flag, cost delta) per candidate baby per cycle — and the host
recorder assembles them into the reference-style event stream
("mutation"/"crossover" with parents, child, the member that died, and
the accept decision), alongside the per-iteration lineage snapshots and
the hall of fame with equation strings.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["Recorder"]


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as numpy."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _sanitize(v):
    if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
        return str(v)
    return v


class Recorder:
    """Accumulates RecordType-style nested dicts (src/ProgramConstants.jl).

    ``stream_path``: when given AND ``recorder_verbosity >= 2`` (the
    per-event rejection mode, whose host dicts dominate memory — see
    ``_assemble_events``), each iteration's record is spilled to that
    path as one JSONL line the moment it is assembled, instead of
    holding every iteration in memory until teardown; ``write()`` merges
    the spilled stream back so the on-disk JSON layout is identical to
    the in-memory path, and removes the stream file.
    """

    def __init__(self, options, stream_path: Optional[str] = None) -> None:
        self.verbosity = int(getattr(options, "recorder_verbosity", 1))
        self._stream_path = stream_path if self.verbosity >= 2 else None
        if self._stream_path is not None:
            d = os.path.dirname(self._stream_path)
            if d:
                os.makedirs(d, exist_ok=True)
            open(self._stream_path, "w").close()  # truncate stale stream
        self.record: Dict[str, Any] = {
            "options": repr(options),
            "iterations": [],
            "final_state": {},
        }

    def record_iteration(
        self,
        iteration: int,
        out_idx: int,
        state,
        hof,
        num_evals: float,
        variable_names: Optional[Sequence[str]] = None,
        events=None,
    ) -> None:
        pops = state.pops
        ref = _host(pops.ref)
        parent = _host(pops.parent)
        cost = _host(pops.cost).astype(np.float64)
        loss = _host(pops.loss).astype(np.float64)
        cx = _host(pops.complexity)
        birth = _host(pops.birth)
        islands: List[Dict[str, Any]] = []
        for i in range(ref.shape[0]):
            islands.append(
                {
                    "ref": ref[i].tolist(),
                    "parent": parent[i].tolist(),
                    "cost": [_sanitize(float(c)) for c in cost[i]],
                    "loss": [_sanitize(float(c)) for c in loss[i]],
                    "complexity": cx[i].tolist(),
                    "birth": birth[i].tolist(),
                }
            )
        event_log = None
        if events is not None:
            event_log = self._assemble_events(events)
        rec = {
            "iteration": iteration,
            "out": out_idx + 1,
            "num_evals": float(num_evals),
            "events": event_log,
            "islands": islands,
            "hall_of_fame": [
                {
                    "complexity": int(e.complexity),
                    "loss": _sanitize(float(e.loss)),
                    "equation": e.equation_string(
                        variable_names=variable_names
                    ),
                }
                for e in hof.entries
            ],
        }
        if self._stream_path is not None:
            # Spill now, free now: verbosity-2 event logs are ~2M dicts
            # per iteration at the bench config; holding a whole run's
            # worth until write() was the memory cliff.
            with open(self._stream_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        else:
            self.record["iterations"].append(rec)

    _REASONS = ("none", "constraint", "invalid", "annealing")

    def _assemble_events(self, events) -> List[Dict[str, Any]]:
        """CycleEvents [I, ncycles, 2B] device arrays -> the
        reference-style per-mutation log (accepted events expanded with
        kind names — src/RegularizedEvolution.jl:47-75 records both
        accepts and rejects). Rejections: per-(kind, reason) aggregate
        counts at ``recorder_verbosity`` 1 (default); every rejected
        candidate becomes its own event (kind, parent, reason) at >= 2.
        Cost note: at the bench config (512 islands x ~40 candidate
        rows x 100 cycles) verbosity 2 assembles ~2M more host dicts
        per iteration — see BASELINE.md."""
        from ..core.options import MUTATION_KINDS

        kind = _host(events.kind)
        parent = _host(events.parent_ref)
        parent2 = _host(events.parent2_ref)
        child = _host(events.child_ref)
        died = _host(events.died_ref)
        accepted = _host(events.accepted)
        delta = _host(events.cost_delta).astype(np.float64)
        reason = _host(events.reject_reason)
        names = list(MUTATION_KINDS) + ["crossover"]
        I, C, NB = kind.shape
        # An accepted row must carry a real kind: phantom slot-2 rows
        # (kind == -1) never replace by construction — names[-1] would
        # silently mislabel one as "crossover" if that ever regressed.
        assert (kind[accepted] >= 0).all(), "accepted event with kind=-1"
        # Bulk-extract every column once (one vectorized gather +
        # .tolist() each) instead of 7 scalar fancy-indexes per event:
        # ~6x less host time at the bench config's ~0.5M accepted
        # events/iteration, where assembly — not the device — bounds
        # recorder-enabled wall-clock (BASELINE.md).
        acc_idx = np.nonzero(accepted)
        cols = [acc_idx[0].tolist(), acc_idx[1].tolist()]  # slot unused
        cols += [a[acc_idx].tolist()
                 for a in (kind, parent, parent2, child, died, delta,
                           reason)]
        out: List[Dict[str, Any]] = []
        rejects: Dict[str, int] = {}
        for isl, cyc, kk, par, p2, ch, dd, dl, r in zip(*cols):
            k = names[kk]
            ev = {
                "island": isl,
                "cycle": cyc,
                "type": k,
                "parent": par,
                "child": ch,
                "died": dd,
                "cost_delta": _sanitize(dl),
            }
            if k == "crossover" and p2 >= 0:
                ev["parent2"] = p2
            if r > 0:  # kept-parent fallback: accepted AND rejected-why
                ev["reject_reason"] = self._REASONS[r]
            out.append(ev)
        rej_mask = ~accepted & (kind >= 0)
        pairs, pair_counts = np.unique(
            np.stack([kind[rej_mask], reason[rej_mask]]),
            axis=1, return_counts=True)
        rejects = {
            f"{names[int(k)]}:{self._REASONS[int(r)]}": int(c)
            for (k, r), c in zip(pairs.T, pair_counts)
        }
        result = {"accepted": out, "rejected_counts": rejects}
        if self.verbosity >= 2:
            rej_idx = np.nonzero(rej_mask)
            rcols = [rej_idx[0].tolist(), rej_idx[1].tolist()]  # slot unused
            rcols += [a[rej_idx].tolist() for a in (kind, parent, reason)]
            result["rejected"] = [
                {
                    "island": isl,
                    "cycle": cyc,
                    "type": names[kk],
                    "parent": par,
                    "reason": self._REASONS[r],
                }
                for isl, cyc, kk, par, r in zip(*rcols)
            ]
        return [result]

    def record_final(self, key: str, value: Any) -> None:
        self.record["final_state"][key] = value

    def write(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        if self._stream_path is None or not os.path.exists(self._stream_path):
            with open(path, "w") as f:
                json.dump(self.record, f)
            return
        # End-of-run merge: splice the spilled per-iteration records
        # (in arrival order, already serialized JSON objects) straight
        # into the output's "iterations" array line by line — loading
        # them all back first would re-materialize the exact event-dict
        # volume the streaming exists to cap. Same JSON layout as the
        # in-memory path (json.dump default separators).
        with open(path, "w") as out:
            out.write('{"options": ' + json.dumps(self.record["options"])
                      + ', "iterations": [')
            first = True
            with open(self._stream_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    out.write(("" if first else ", ") + line)
                    first = False
            for rec in self.record["iterations"]:
                out.write(("" if first else ", ") + json.dumps(rec))
                first = False
            out.write('], "final_state": '
                      + json.dumps(self.record["final_state"]) + "}")
        os.remove(self._stream_path)
