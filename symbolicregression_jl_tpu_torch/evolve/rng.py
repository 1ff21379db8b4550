"""Counter-based randomness, bit-compatible with ``jax.random`` (threefry2x32).

The JAX package draws all evolution randomness from ``jax.random`` keys
with the default threefry2x32 generator in its partitionable form
(``jax_threefry_partitionable``, on by default since jax 0.5): a key is
two uint32 words, ``split``/``fold_in``/``random_bits`` hash a 64-bit
iota counter split into (hi, lo) words. This module computes the same
functions in torch integer ops, so one seed gives the same draws in the
JAX package, on the CPU and on the GPU. Keys are int32 tensors of shape
[..., 2] holding the uint32 bit patterns; batched keys draw batched
samples.

The ``u_*`` samplers and :class:`USlice` port ``evolve/rng.py``: the
evolution step takes slices of one bulk uniform vector instead of many
small sampler calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["key", "split", "fold_in", "random_bits", "uniform", "randint", "bernoulli",
           "gumbel", "categorical", "permutation", "normal", "USlice", "u_randint",
           "u_masked_choice", "u_bernoulli", "u_normal", "u_categorical_weights"]

_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


def _i32(v: int) -> int:
    """uint32 constant as the int32 with the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    # Logical right shift on int32: arithmetic shift, then mask.
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def _rounds(x0, x1, rots):
    for r in rots:
        x0 = x0 + x1
        x1 = _rotl(x1, r)
        x1 = x0 ^ x1
    return x0, x1


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of counter words (x1, x2) under key (k1, k2);
    int32 tensors holding uint32 bits, broadcastable; int32 addition
    wraps modulo 2^32."""
    k3 = k1 ^ k2 ^ _i32(_PARITY)
    ks = (k1, k2, k3)
    x0 = x1 + ks[0]
    x1 = x2 + ks[1]
    for i, rots in enumerate((_ROT0, _ROT1, _ROT0, _ROT1, _ROT0)):
        x0, x1 = _rounds(x0, x1, rots)
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + (i + 1)
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` key data for a 32-bit seed: (0, seed)."""
    return torch.tensor([0, _i32(int(seed))], dtype=torch.int32, device=device)


def _iota_lo(shape, device) -> torch.Tensor:
    size = math.prod(shape)
    if size >= (1 << 32):
        raise NotImplementedError("random arrays of 2^32 or more elements")
    lo = torch.arange(size, dtype=torch.int64, device=device)
    lo = torch.where(lo >= (1 << 31), lo - (1 << 32), lo).to(torch.int32)
    return lo.reshape(shape)


def _hash_shape(k: torch.Tensor, shape):
    """threefry of the iota counter of ``shape`` under keys ``k`` [..., 2]:
    outputs [..., *shape] each."""
    lo = _iota_lo(tuple(shape), k.device)
    pad = (1,) * len(shape)
    k1 = k[..., 0].reshape(k.shape[:-1] + pad)
    k2 = k[..., 1].reshape(k.shape[:-1] + pad)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys [..., 2] -> [..., num, 2]."""
    b1, b2 = _hash_shape(k, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` with a scalar (or [...]-shaped) uint32 datum."""
    d = torch.as_tensor(data, device=k.device)
    d = (d.to(torch.int64) & 0xFFFFFFFF)
    d = torch.where(d >= (1 << 31), d - (1 << 32), d).to(torch.int32)
    b1, b2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def random_bits(k: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element (int32 bit patterns): [..., *shape]."""
    b1, b2 = _hash_shape(k, shape)
    return b1 ^ b2


def _uniform64(k: torch.Tensor, shape, minval: float, maxval: float) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float64)`` (under x64): 64 random
    bits per value, the two threefry outputs as the high and low words,
    their top 52 bits as the mantissa of a float in [1, 2)."""
    b1, b2 = _hash_shape(k, shape)
    mask = 0xFFFFFFFF
    bits = ((b1.to(torch.int64) & mask) << 32) | (b2.to(torch.int64) & mask)
    fbits = ((bits >> 12) & ((1 << 52) - 1)) | 0x3FF0000000000000
    floats = fbits.view(torch.float64) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return floats
    # XLA may fuse the scaling into one multiply-add; here it is two
    # roundings, so a scaled draw can sit an ULP from JAX's.
    lo = torch.tensor(minval, dtype=torch.float64, device=k.device)
    return torch.maximum(lo, floats * (maxval - minval) + minval)


def uniform(k: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.uniform`` in [minval, maxval): [..., *shape], float32
    (32 random bits per value) or float64 (64 bits, as the JAX package
    draws its default-dtype uniforms under x64)."""
    if dtype == torch.float64:
        return _uniform64(k, shape, minval, maxval)
    bits = random_bits(k, shape)
    fbits = ((bits >> 9) & 0x7FFFFF) | 0x3F800000
    floats = fbits.view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return floats
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=k.device)
    # XLA contracts ``floats * (hi - lo) + lo`` into one fused multiply-add.
    # The float64 product of two float32 values is exact, so a float64 add
    # rounded to float32 gives the fused result.
    scaled = (floats.double() * (hi - lo).double() + lo.double()).to(torch.float32)
    return torch.maximum(lo, scaled)


def randint(k: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32:
    [..., *shape] in [minval, maxval). Two 32-bit words per value (from
    the two halves of a split key) reduced modulo the span, with JAX's
    uint32 arithmetic (int64 here, masked back to 32 bits)."""
    span = max(int(maxval) - int(minval), 1)
    ks = split(k, 2)
    mask = 0xFFFFFFFF
    hi = random_bits(ks[..., 0, :], shape).to(torch.int64) & mask
    lo = random_bits(ks[..., 1, :], shape).to(torch.int64) & mask
    multiplier = (((1 << 16) % span) ** 2 & mask) % span
    offset = ((hi % span) * multiplier + lo % span) & mask
    return (int(minval) + offset % span).to(torch.int32)


def bernoulli(k: torch.Tensor, p: float, shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.bernoulli``: a ``dtype`` uniform below p (float64 under
    x64, where p's dtype is float64)."""
    return uniform(k, shape, dtype=dtype) < torch.tensor(p, dtype=dtype, device=k.device)


def gumbel(k: torch.Tensor, shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in ``dtype``."""
    tiny = float(torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(uniform(k, shape, minval=tiny, maxval=1.0, dtype=dtype)))


def categorical(k: torch.Tensor, logits: torch.Tensor, shape=None) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of ``logits``.

    ``k`` is one key [2] (``shape`` = batch shape of the draw, default
    ``logits.shape[:-1]``) or a batch of keys [..., 2] each drawing one
    sample from ``logits`` [..., n] (broadcast). The Gumbel noise takes
    the logits' dtype, as in JAX."""
    n = logits.shape[-1]
    dt = torch.float64 if logits.dtype == torch.float64 else torch.float32
    if k.dim() == 1:
        batch = tuple(logits.shape[:-1]) if shape is None else tuple(shape)
        g = gumbel(k, batch + (n,), dt)
    else:
        g = gumbel(k, (n,), dt)
    return torch.argmax(g + logits, dim=-1).to(torch.int32)


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for keys [..., 2] -> [..., n]
    (rounds of a stable sort by random 32-bit keys)."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, device=k.device).expand(*k.shape[:-1], n)
    for _ in range(rounds):
        ks = split(k, 2)
        k, sub = ks[..., 0, :], ks[..., 1, :]
        sort_keys = random_bits(sub, (n,)).to(torch.int64) & 0xFFFFFFFF
        order = torch.argsort(sort_keys, dim=-1, stable=True)
        x = torch.gather(x, -1, order)
    return x


# ---------------------------------------------------------------------------
# Bulk-uniform samplers
# ---------------------------------------------------------------------------


class USlice:
    """Cursor over the last axis of a uniform(0,1) tensor: each ``take``
    returns the next ``n`` columns."""

    def __init__(self, u: torch.Tensor):
        self.u = u
        self.i = 0

    def take(self, n: int) -> torch.Tensor:
        s = self.u[..., self.i:self.i + n]
        self.i += n
        return s

    def take1(self) -> torch.Tensor:
        return self.take(1)[..., 0]


def u_randint(u: torch.Tensor, n) -> torch.Tensor:
    """Uniform int in [0, n) from uniform ``u`` (n an int or int tensor >= 1)."""
    if isinstance(n, torch.Tensor):
        return torch.minimum((u * n).to(torch.int32), (n - 1).to(torch.int32))
    return torch.clamp((u * n).to(torch.int32), max=n - 1)


def u_masked_choice(u_vec: torch.Tensor, mask: torch.Tensor):
    """Uniform choice among True entries of ``mask`` [..., K] from a
    [..., K] uniform slice; (index, has_any), index 0 when none."""
    has_any = mask.any(dim=-1)
    idx = torch.argmax(torch.where(mask, u_vec, -1.0), dim=-1).to(torch.int32)
    return torch.where(has_any, idx, 0), has_any


def u_bernoulli(u, p: float = 0.5):
    return u < p


_NDTRI_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1,
             -5.66762857469070293439E1, 1.39312609387279679503E1,
             -1.23916583867381258016E0)
_NDTRI_Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0,
             8.63602421390890590575E1, -2.25462687854119370527E2,
             2.00260212380060660359E2, -8.20372256168333339912E1,
             1.59056225126211695515E1, -1.18331621121330003142E0)
_NDTRI_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1,
             5.71628192246421288162E1, 4.40805073893200834700E1,
             1.46849561928858024014E1, 2.18663306850790267539E0,
             -1.40256079171354495875E-1, -3.50424626827848203418E-2,
             -8.57456785154685413611E-4)
_NDTRI_Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1,
             4.13172038254672030440E1, 1.50425385692907503408E1,
             2.50464946208309415979E0, -1.42182922854787788574E-1,
             -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_NDTRI_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0,
             3.93881025292474443415E0, 1.33303460815807542389E0,
             2.01485389549179081538E-1, 1.23716634817820021358E-2,
             3.01581553508235416007E-4, 2.65806974686737550832E-6,
             6.23974539184983293730E-9)
_NDTRI_Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0,
             1.37702099489081330271E0, 2.16236993594496635890E-1,
             1.34204006088543189037E-2, 3.28014464682127739104E-4,
             2.89247864745380683936E-6, 6.79019408009981274425E-9)


def _polyval(coeffs, x):
    """Horner's rule with each step one fused multiply-add, as XLA
    contracts it: the float64 product of two float32 values is exact, so
    a float64 add rounded to float32 gives the fused result. A float64 x
    takes plain float64 steps (an ULP from a fused evaluation at most)."""
    if x.dtype == torch.float64:
        y = torch.zeros_like(x)
        for c in coeffs:
            y = y * x + c
        return y
    y = torch.zeros_like(x, dtype=torch.float64)
    x64 = x.double()
    for c in coeffs:
        y = (y * x64 + float(np.float32(c))).to(x.dtype).double()
    return y.to(x.dtype)


def _f32(v: float) -> float:
    return float(np.float32(v))


def ndtri(p: torch.Tensor) -> torch.Tensor:
    """Inverse normal CDF: the same Cephes piecewise rational
    approximation, in the same operation order, as
    ``jax.scipy.special.ndtri``. In float32 the central branch gives the
    JAX package's bits; the tails go through ``log``, whose float32 results
    differ from XLA's CPU ones by an ULP here and there. float64 takes its
    constants unrounded."""
    cv = float if p.dtype == torch.float64 else _f32
    big = cv(-np.expm1(-2.0))
    mcp = torch.where(p > big, 1.0 - p, p)
    mcp = torch.where(mcp == 0.0, 0.5, mcp)
    w = mcp - 0.5
    ww = w * w
    x_big = w + w * ww * (_polyval(_NDTRI_P0, ww) / _polyval(_NDTRI_Q0, ww))
    x_big = x_big * -cv(np.sqrt(2.0 * np.pi))
    z = torch.sqrt(-2.0 * torch.log(mcp))
    first = z - torch.log(z) / z
    iz = 1 / z
    second_small = _polyval(_NDTRI_P2, iz) / _polyval(_NDTRI_Q2, iz) / z
    second_other = _polyval(_NDTRI_P1, iz) / _polyval(_NDTRI_Q1, iz) / z
    x = torch.where(mcp > cv(np.exp(-2.0)), x_big,
                    torch.where(z >= 8.0, first - second_small, first - second_other))
    x = torch.where(p > cv(1.0 - np.exp(-2.0)), x, -x)
    x = torch.where(p == 0.0, -torch.inf, torch.where(p == 1.0, torch.inf, x))
    return x


# XLA's float32 ErfInv (the chlo decomposition): Giles' single-precision
# polynomials in w = -log1p(-x*x), one for w < 5 and one above.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# XLA's CPU log1p: a Cephes rational function below sqrt(2) - 1, else log(1 + x).
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
# XLA's CPU logf: the Cephes polynomial.
_LOGF_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
           1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
           3.3333331174E-1)


def _fma(a, b, c):
    """float32 fused multiply-add (float64 product of float32 values is exact)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    return (a.double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).to(torch.float32)


def _xla_logf(v: torch.Tensor) -> torch.Tensor:
    """float32 natural log, XLA CPU's Cephes evaluation (finite v > 0)."""
    m, e = torch.frexp(torch.clamp(v, min=_f32(np.finfo(np.float32).tiny)))
    e = e.to(torch.float32)
    small = m < _f32(np.sqrt(0.5))
    e = e - small.to(torch.float32)
    x = (m - 1.0) + torch.where(small, m, 0.0)
    x2 = x * x
    x3 = x2 * x
    p = [_f32(c) for c in _LOGF_P]
    y, y1, y2 = _fma(p[0], x, p[1]), _fma(p[3], x, p[4]), _fma(p[6], x, p[7])
    y, y1, y2 = _fma(y, x, p[2]), _fma(y1, x, p[5]), _fma(y2, x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2) * x3
    y = _fma(e, _f32(-2.12194440e-4), y)
    x = _fma(_f32(-0.5), x2, x) + y
    return _fma(e, _f32(0.693359375), x)


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p as XLA's CPU backend computes it (x > -1)."""
    x2 = x * x
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for c in _LOG1P_NUM:
        num = _fma(num, x, _f32(c))
    for c in _LOG1P_DEN:
        den = _fma(den, x, _f32(c))
    small = x + _fma(_f32(-0.5), x2, (x * x2) * (num / den))
    return torch.where(x.abs() < _f32(np.sqrt(2.0) - 1.0), small, _xla_logf(x + 1.0))


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` in float32 with XLA's polynomial, each Horner
    step one fused multiply-add. Bit-equal to the JAX package's CPU
    results where x*x < sqrt(2) - 1 (the rational log1p branch); past it
    XLA's CPU logf is emulated and a few values in 10^5 differ by an ULP."""
    w = -_xla_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    lo = torch.tensor([_f32(c) for c in _ERFINV_LT5], device=x.device)
    hi = torch.tensor([_f32(c) for c in _ERFINV_GE5], device=x.device)
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, torch.where(lt, lo[i], hi[i]))
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


def normal(k: torch.Tensor, shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal``: sqrt(2) * erf_inv(u), u uniform on
    (nextafter(-1, 0), 1): [..., *shape]. float64 draws 64-bit uniforms
    (JAX under x64) and takes ``torch.special.erfinv``, within an ULP or
    two of XLA's float64 ErfInv."""
    if dtype == torch.float64:
        lo64 = float(np.nextafter(-1.0, 0.0))
        return math.sqrt(2.0) * torch.special.erfinv(uniform(k, shape, lo64, 1.0, torch.float64))
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _f32(np.sqrt(2.0)) * _erf_inv(uniform(k, shape, lo, 1.0))


def u_normal(u: torch.Tensor) -> torch.Tensor:
    """Standard normal via the inverse CDF."""
    return ndtri(torch.clamp(u, 1e-7, 1.0 - 1e-7))


def u_categorical_weights(u_vec: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Index ~ weights (non-negative, last axis) via the Gumbel trick on a
    uniform slice of the same width."""
    g = -torch.log(-torch.log(torch.clamp(u_vec, 1e-12, 1.0 - 1e-7)))
    logits = torch.where(weights > 0, torch.log(torch.clamp(weights, min=1e-30)), -torch.inf)
    return torch.argmax(logits + g, dim=-1).to(torch.int32)
