"""Expression specifications: which expression family the search evolves
(port of ``models/spec.py``).

- ``ExpressionSpec``: plain expression trees (the default).
- ``TemplateExpressionSpec``: K named subexpressions combined by a user
  structure function (models/template.py).
- ``ParametricExpressionSpec``: trees with parameter leaves ``p1..pK``;
  every member has a (max_parameters, n_classes) bank, and a leaf reads
  the entry of the row's class (the dataset's ``class`` column, given
  through ``equation_search(extra={"class": ...})``).
"""

from __future__ import annotations

import dataclasses

__all__ = ["ExpressionSpec", "ParametricExpressionSpec", "TemplateExpressionSpec"]


@dataclasses.dataclass(frozen=True)
class ExpressionSpec:
    """Default spec: plain expression trees."""


@dataclasses.dataclass(frozen=True)
class ParametricExpressionSpec(ExpressionSpec):
    """Parametric expressions with a (max_parameters, num_classes)
    parameter matrix per member, indexed by the dataset's ``class``
    column."""

    max_parameters: int = 2

    def __post_init__(self):
        if self.max_parameters < 1:
            raise ValueError("max_parameters must be >= 1")


@dataclasses.dataclass(frozen=True)
class TemplateExpressionSpec(ExpressionSpec):
    """Template expressions; build ``structure`` with
    :func:`~.template.template_spec` or :func:`~.template.make_template_structure`."""

    structure: "object" = None  # TemplateStructure

    def __post_init__(self):
        from .template import TemplateStructure

        if not isinstance(self.structure, TemplateStructure):
            raise ValueError("TemplateExpressionSpec requires structure=TemplateStructure")
