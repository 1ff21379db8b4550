"""Expression families (port of ``models/``): expression specs, template
expressions and the ValidVector algebra their combiners use."""

from .composable import ComposableExpression, ParamVec, ValidVector
from .spec import ExpressionSpec, ParametricExpressionSpec, TemplateExpressionSpec
from .template import D, TemplateStructure, make_template_structure, template_spec

__all__ = [
    "ExpressionSpec",
    "ParametricExpressionSpec",
    "TemplateExpressionSpec",
    "TemplateStructure",
    "make_template_structure",
    "template_spec",
    "D",
    "ComposableExpression",
    "ParamVec",
    "ValidVector",
]
