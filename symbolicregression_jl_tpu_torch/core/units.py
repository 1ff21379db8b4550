"""SI units: parsing, arithmetic, and printing (a copy of the JAX
package's ``core/units.py``, numpy only).

Host-side analogue of the Julia reference's ``InterfaceDynamicQuantities.jl``
(src/InterfaceDynamicQuantities.jl:55-89): user unit specs (strings like
``"m/s^2"``, ``"kg*m"``) are parsed into a 7-exponent SI dimension vector
plus a scale factor. Only the *dimensions* participate in dimensional
analysis (DynamicQuantities semantics: magnitudes do not rescale data).

The device-side dimensional check consumes :func:`dims_to_array` vectors;
see :mod:`..ops.dims_eval`.
"""

from __future__ import annotations

import dataclasses
import re
from fractions import Fraction
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "Dimensions",
    "Quantity",
    "parse_unit",
    "dims_to_array",
    "pretty_dims",
    "DIMENSIONLESS",
    "N_DIMS",
]

# Base dimension order: length, mass, time, current, temperature,
# luminosity, amount (DynamicQuantities' canonical order).
N_DIMS = 7
_DIM_NAMES = ("m", "kg", "s", "A", "K", "cd", "mol")


@dataclasses.dataclass(frozen=True)
class Dimensions:
    """Rational exponents over the 7 SI base dimensions."""

    exps: Tuple[Fraction, ...] = (Fraction(0),) * N_DIMS

    def __post_init__(self):
        assert len(self.exps) == N_DIMS

    @staticmethod
    def base(i: int, exp=1) -> "Dimensions":
        e = [Fraction(0)] * N_DIMS
        e[i] = Fraction(exp)
        return Dimensions(tuple(e))

    def __mul__(self, other: "Dimensions") -> "Dimensions":
        return Dimensions(tuple(a + b for a, b in zip(self.exps, other.exps)))

    def __truediv__(self, other: "Dimensions") -> "Dimensions":
        return Dimensions(tuple(a - b for a, b in zip(self.exps, other.exps)))

    def __pow__(self, p) -> "Dimensions":
        p = Fraction(p).limit_denominator(1000) if not isinstance(p, Fraction) else p
        return Dimensions(tuple(a * p for a in self.exps))

    @property
    def is_dimensionless(self) -> bool:
        return all(e == 0 for e in self.exps)

    def __str__(self) -> str:
        return pretty_dims(self)


DIMENSIONLESS = Dimensions()


@dataclasses.dataclass(frozen=True)
class Quantity:
    """A scale factor times SI dimensions (e.g. km = 1000 * m)."""

    scale: float = 1.0
    dims: Dimensions = DIMENSIONLESS

    def __mul__(self, other: "Quantity") -> "Quantity":
        return Quantity(self.scale * other.scale, self.dims * other.dims)

    def __truediv__(self, other: "Quantity") -> "Quantity":
        return Quantity(self.scale / other.scale, self.dims / other.dims)

    def __pow__(self, p) -> "Quantity":
        return Quantity(self.scale ** float(p), self.dims ** p)


def _q(scale: float, **dims) -> Quantity:
    idx = {n: i for i, n in enumerate(_DIM_NAMES)}
    e = [Fraction(0)] * N_DIMS
    for name, exp in dims.items():
        e[idx[name]] = Fraction(exp)
    return Quantity(scale, Dimensions(tuple(e)))


# SI base + common derived units. Mass base is kg; "g" carries scale 1e-3.
_UNIT_TABLE: Dict[str, Quantity] = {
    "": Quantity(),
    "1": Quantity(),
    "m": _q(1, m=1),
    "g": _q(1e-3, kg=1),
    "s": _q(1, s=1),
    "A": _q(1, A=1),
    "K": _q(1, K=1),
    "cd": _q(1, cd=1),
    "mol": _q(1, mol=1),
    # Derived
    "Hz": _q(1, s=-1),
    "N": _q(1, kg=1, m=1, s=-2),
    "Pa": _q(1, kg=1, m=-1, s=-2),
    "J": _q(1, kg=1, m=2, s=-2),
    "W": _q(1, kg=1, m=2, s=-3),
    "C": _q(1, A=1, s=1),
    "V": _q(1, kg=1, m=2, s=-3, A=-1),
    "F": _q(1, kg=-1, m=-2, s=4, A=2),
    "Ohm": _q(1, kg=1, m=2, s=-3, A=-2),
    "S": _q(1, kg=-1, m=-2, s=3, A=2),
    "Wb": _q(1, kg=1, m=2, s=-2, A=-1),
    "T": _q(1, kg=1, s=-2, A=-1),
    "H": _q(1, kg=1, m=2, s=-2, A=-2),
    "L": _q(1e-3, m=3),
    "bar": _q(1e5, kg=1, m=-1, s=-2),
    "eV": _q(1.602176634e-19, kg=1, m=2, s=-2),
    "min": _q(60, s=1),
    "h": _q(3600, s=1),
    "hr": _q(3600, s=1),
    "day": _q(86400, s=1),
    "rad": Quantity(),
    "sr": Quantity(),
    "deg": Quantity(np.pi / 180),
    "percent": Quantity(0.01),
}

_PREFIXES: Dict[str, float] = {
    "y": 1e-24, "z": 1e-21, "a": 1e-18, "f": 1e-15, "p": 1e-12,
    "n": 1e-9, "u": 1e-6, "µ": 1e-6, "μ": 1e-6, "m": 1e-3, "c": 1e-2,
    "d": 1e-1, "da": 1e1, "h": 1e2, "k": 1e3, "M": 1e6, "G": 1e9,
    "T": 1e12, "P": 1e15, "E": 1e18, "Z": 1e21, "Y": 1e24,
}

_EXP_RE = re.compile(r"^(?P<unit>[^\^]+?)(?:\^(?P<exp>-?\d+(?:\.\d+)?(?://\d+)?))?$")


def _lookup_unit(token: str) -> Quantity:
    if token in _UNIT_TABLE:
        return _UNIT_TABLE[token]
    # Prefix split: longest prefix first ("da" before "d").
    for plen in (2, 1):
        if len(token) > plen:
            pre, rest = token[:plen], token[plen:]
            if pre in _PREFIXES and rest in _UNIT_TABLE:
                base = _UNIT_TABLE[rest]
                return Quantity(base.scale * _PREFIXES[pre], base.dims)
    raise ValueError(f"Unknown unit {token!r}")


def _parse_factor(token: str) -> Quantity:
    m = _EXP_RE.match(token)
    if m is None:
        raise ValueError(f"Cannot parse unit factor {token!r}")
    q = _lookup_unit(m.group("unit").strip())
    exp_s = m.group("exp")
    if exp_s is None:
        return q
    if "//" in exp_s:
        num, den = exp_s.split("//")
        exp: Union[Fraction, float] = Fraction(int(num), int(den))
    elif "." in exp_s:
        exp = float(exp_s)
    else:
        exp = Fraction(int(exp_s))
    return q ** exp


def parse_unit(spec) -> Quantity:
    """Parse a unit spec into a :class:`Quantity`.

    Accepts: ``None``/``""``/``"1"`` (dimensionless), strings like
    ``"m/s^2"``, ``"kg*m^2/s^2"``, ``"m s^-1"`` (space = multiply), a
    :class:`Quantity`/:class:`Dimensions`, or a 7-sequence of exponents.
    """
    if spec is None:
        return Quantity()
    if isinstance(spec, Quantity):
        return spec
    if isinstance(spec, Dimensions):
        return Quantity(1.0, spec)
    if isinstance(spec, (list, tuple, np.ndarray)) and len(spec) == N_DIMS:
        return Quantity(
            1.0,
            Dimensions(
                tuple(Fraction(float(e)).limit_denominator(1000) for e in spec)
            ),
        )
    s = str(spec).strip()
    if s in ("", "1"):
        return Quantity()
    # Tokenize factors and '*'/'/' dividers. The factor pattern consumes a
    # whole `unit^exp` including rational `//` exponents (`m^1//2`), so the
    # exponent's slashes are never mistaken for division.
    token_re = re.compile(
        r"[^\s*/^]+(?:\^-?[0-9]+(?://[0-9]+|\.[0-9]+)?)?|[*/]"
    )
    q = Quantity()
    divide = False
    pos = 0
    for m in token_re.finditer(s):
        if s[pos:m.start()].strip():
            raise ValueError(f"Cannot parse unit spec {spec!r}")
        pos = m.end()
        part = m.group(0)
        if part == "*":
            divide = False
            continue
        if part == "/":
            divide = True
            continue
        factor = _parse_factor(part)
        q = q / factor if divide else q * factor
        # After a '/', only the immediately following factor is divided
        # when separated by spaces; '/' binds to the next single factor.
        divide = False
    if s[pos:].strip():
        raise ValueError(f"Cannot parse unit spec {spec!r}")
    return q


def dims_to_array(dims: Dimensions) -> np.ndarray:
    """[7] float32 exponent vector for the device-side check."""
    return np.asarray([float(e) for e in dims.exps], np.float32)


_SUP = str.maketrans("0123456789-./", "⁰¹²³⁴⁵⁶⁷⁸⁹⁻·ᐟ")


def pretty_dims(dims: Dimensions) -> str:
    """Render dimensions like ``m s⁻²`` (empty string if dimensionless)."""
    parts = []
    for name, e in zip(_DIM_NAMES, dims.exps):
        if e == 0:
            continue
        if e == 1:
            parts.append(name)
        else:
            parts.append(name + str(e).translate(_SUP))
    return " ".join(parts)


def units_to_dims_arrays(
    X_units: Optional[Sequence], nfeatures: int, y_units=None
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Parse per-feature / output unit specs into dims arrays.

    Returns ``(x_dims[nfeatures, 7], y_dims[7])``. ``x_dims`` is None only
    when no units were given at all; unspecified feature units default to
    dimensionless. ``y_dims`` is None whenever ``y_units`` was not given —
    the output-dimension check is then skipped entirely (matching the
    reference, src/DimensionalAnalysis.jl:250-255: a missing y unit
    accepts any output dims).
    """
    if X_units is None and y_units is None:
        return None, None
    if X_units is None:
        x_dims = np.zeros((nfeatures, N_DIMS), np.float32)
    else:
        if len(X_units) != nfeatures:
            raise ValueError(
                f"X_units has {len(X_units)} entries for {nfeatures} features"
            )
        x_dims = np.stack([dims_to_array(parse_unit(u).dims) for u in X_units])
    y_dims = None if y_units is None else dims_to_array(parse_unit(y_units).dims)
    return x_dims, y_dims


class QuantityArray(np.ndarray):
    """A numpy array carrying a unit specification string.

    The Python face of the reference's unit-typed MLJ predictions
    (src/MLJInterface.jl:366-380): predictions echo the ``y_units``
    given at fit time via ``.unit`` while behaving as plain arrays
    everywhere else.
    """

    def __new__(cls, values, unit):
        obj = np.asarray(values).view(cls)
        obj.unit = unit
        return obj

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.unit = getattr(obj, "unit", None)
