"""Host-side hall of fame: pareto frontier, scores, formatting, CSV files.

Port of ``symbolicregression_jl_tpu/api/hall_of_fame.py``. The
device-resident `HofState` (best member per complexity, evolve/step.py) is
decoded into host `Node` trees here (with their (n_params, n_classes)
parameter matrix for parametric members), or into a
`HostTemplateExpression` of named subtrees and parameter values for
template members. The CSV files are byte-equal to the JAX package's for
the same entries, and each package reads the other's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np

from ..ops.encoding import decode_tree
from ..ops.operators import OperatorSet
from ..ops.tree import Node, parse_expression, string_tree

__all__ = ["HallOfFameEntry", "HallOfFame", "calculate_pareto_frontier", "compute_scores",
           "string_dominating_pareto_curve", "save_hall_of_fame_csv", "load_hall_of_fame_csv"]


@dataclasses.dataclass
class HallOfFameEntry:
    """One best-at-complexity member. Parametric members carry their
    (n_params, n_classes) ``params``; template members decode to
    ``template_expr`` (a HostTemplateExpression) and have no ``tree``."""

    tree: Optional[Node]
    loss: float
    cost: float
    complexity: int
    score: float = 0.0
    params: Optional[np.ndarray] = None
    template_expr: Optional["object"] = None

    def equation_string(self, variable_names=None, precision: int = 5) -> str:
        if self.template_expr is not None:
            # Subexpression arguments print as #1..#k; variable names do not apply.
            return self.template_expr.string(precision=precision)
        return string_tree(self.tree, variable_names=variable_names, precision=precision)


@dataclasses.dataclass
class HallOfFame:
    """Best member per complexity level."""

    entries: List[HallOfFameEntry]

    @staticmethod
    def from_device(hof_state, operators: OperatorSet, template=None) -> "HallOfFame":
        """Decode a device HofState into host entries (existing only).
        With ``template`` (a TemplateStructure) the trees carry a key axis
        [maxsize, K, L] and each entry decodes to a HostTemplateExpression."""
        host = lambda t: t.detach().cpu().numpy()
        exists = host(hof_state.exists)
        cost = host(hof_state.cost)
        loss = host(hof_state.loss)
        complexity = host(hof_state.complexity)
        params = host(hof_state.params)
        has_params = params.shape[-2] > 0
        fields = [host(f) for f in hof_state.trees.fields()]

        def decode(*index):
            return decode_tree(*(f[index] for f in fields), operators)

        def entry(i):
            common = dict(loss=float(loss[i]), cost=float(cost[i]),
                          complexity=int(complexity[i]))
            if template is None:
                return HallOfFameEntry(tree=decode(i), params=params[i] if has_params else None,
                                       **common)
            from ..models.template import HostTemplateExpression

            trees = {key: decode(i, k) for k, key in enumerate(template.expr_keys)}
            return HallOfFameEntry(tree=None, template_expr=HostTemplateExpression(
                trees=trees, structure=template, operators=operators,
                params=params[i, :, 0] if has_params else None), **common)

        entries = [entry(i) for i in range(exists.shape[0]) if exists[i]]
        entries.sort(key=lambda e: e.complexity)
        return HallOfFame(entries=entries)

    def pareto_frontier(self) -> List[HallOfFameEntry]:
        return calculate_pareto_frontier(self.entries)


def calculate_pareto_frontier(entries: Sequence[HallOfFameEntry]) -> List[HallOfFameEntry]:
    """Members whose loss beats every simpler member."""
    frontier: List[HallOfFameEntry] = []
    best = np.inf
    for e in sorted(entries, key=lambda e: e.complexity):
        if np.isfinite(e.loss) and e.loss < best:
            frontier.append(e)
            best = e.loss
    return frontier


def compute_scores(frontier: Sequence[HallOfFameEntry],
                   loss_scale: str = "log") -> List[HallOfFameEntry]:
    """Attach score = -dlog(loss)/dcomplexity (log scale) or the negative
    slope (linear scale) against the previous frontier member."""
    ZERO_POINT = 1e-12
    out = []
    prev_loss = prev_c = None
    for e in frontier:
        if prev_loss is None:
            score = 0.0
        else:
            dc = max(e.complexity - prev_c, 1)
            if loss_scale == "log":
                score = -(np.log(max(e.loss, ZERO_POINT)) - np.log(max(prev_loss, ZERO_POINT))) / dc
            else:
                score = -(e.loss - prev_loss) / dc
        out.append(dataclasses.replace(e, score=float(score)))
        prev_loss, prev_c = e.loss, e.complexity
    return out


def string_dominating_pareto_curve(hof: HallOfFame, operators: OperatorSet,
                                   variable_names: Optional[Sequence[str]] = None,
                                   loss_scale: str = "log", precision: int = 5,
                                   width: int = 100) -> str:
    """Terminal table of the dominating pareto frontier."""
    del operators
    frontier = compute_scores(hof.pareto_frontier(), loss_scale)
    sep = "─" * width
    lines = ["┌" + sep + "┐"]
    header = f"{'Complexity':<12}{'Loss':<12}{'Score':<12}Equation"
    lines.append("│ " + header.ljust(width - 2) + " │")
    for e in frontier:
        eq = e.equation_string(variable_names=variable_names, precision=precision)
        row = f"{e.complexity:<12d}{e.loss:<12.4g}{e.score:<12.4g}{eq}"
        while len(row) > width - 4:
            lines.append("│ " + row[: width - 4].ljust(width - 2) + " │")
            row = " " * 36 + row[width - 4:]
        lines.append("│ " + row.ljust(width - 2) + " │")
    lines.append("└" + sep + "┘")
    return "\n".join(lines)


def save_hall_of_fame_csv(path: str, hof: HallOfFame, operators: OperatorSet,
                          variable_names: Optional[Sequence[str]] = None,
                          precision: int = 12) -> None:
    """Write a ``Complexity,Loss,Equation`` CSV: the body goes to
    ``path + ".bak"`` first and is then moved over ``path``, so a crash
    mid-write never leaves a half-written file. Parametric entries add a
    ``Parameters`` column, the (n_params, n_classes) bank flattened and
    ;-separated, so a warm start restores the fitted parameters."""
    del operators
    parametric = any(e.params is not None for e in hof.entries)
    header = "Complexity,Loss,Equation"
    rows = [header + ",Parameters" if parametric else header]
    for e in hof.entries:
        eq = e.equation_string(variable_names=variable_names, precision=precision)
        row = f'{e.complexity},{e.loss!r},"{eq}"'
        if parametric:
            p = (";".join(repr(float(v)) for v in np.asarray(e.params).ravel())
                 if e.params is not None else "")
            row += f',"{p}"'
        rows.append(row)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    bak = path + ".bak"
    with open(bak, "w") as f:
        f.write("\n".join(rows) + "\n")
    os.replace(bak, path)


def load_hall_of_fame_csv(path: str, operators: OperatorSet,
                          variable_names: Optional[Sequence[str]] = None,
                          return_params: bool = False):
    """Parse a hall-of-fame CSV back into trees (the warm-start path).
    ``return_params=True`` also returns each entry's flat parameter vector
    from the ``Parameters`` column (None where absent)."""
    import csv

    trees: List[Node] = []
    params: List[Optional[np.ndarray]] = []
    with open(path) as f:
        reader = csv.reader(f)
        header = next(reader, None)
        if header is None or not header[0].startswith("Complexity"):
            raise ValueError(f"Not a hall-of-fame CSV: {path}")
        has_params = len(header) > 3 and header[3] == "Parameters"
        for parts in reader:
            if not parts:
                continue
            trees.append(parse_expression(parts[2].strip(), operators,
                                          variable_names=variable_names))
            params.append(np.asarray([float(v) for v in parts[3].split(";")])
                          if has_params and len(parts) > 3 and parts[3] else None)
    return (trees, params) if return_params else trees
