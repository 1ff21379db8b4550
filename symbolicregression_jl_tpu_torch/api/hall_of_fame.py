"""Host-side hall of fame: pareto frontier, scores, formatting.

Port of ``symbolicregression_jl_tpu/api/hall_of_fame.py``. The
device-resident `HofState` (best member per complexity, evolve/step.py) is
decoded into host `Node` trees here (with their (n_params, n_classes)
parameter matrix for parametric members), or into a
`HostTemplateExpression` of named subtrees and parameter values for
template members.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..ops.encoding import decode_tree
from ..ops.operators import OperatorSet
from ..ops.tree import Node, string_tree

__all__ = ["HallOfFameEntry", "HallOfFame", "calculate_pareto_frontier", "compute_scores",
           "string_dominating_pareto_curve"]


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
