"""Expression specifications: which expression family the search evolves
(port of ``models/spec.py``).

- ``ExpressionSpec``: plain expression trees (the default).
- ``TemplateExpressionSpec``: K named subexpressions combined by a user
  structure function (models/template.py).
- ``ParametricExpressionSpec``: trees with per-class parameter leaves. The
  type exists so that options carrying it compare and print as in the JAX
  package; the port refuses it (``core.options.check_supported``) until
  the parametric variant of kernel #1 is ported.
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
