"""``jax.random``'s counter-based generator on torch tensors.

The reference draws every fault realization from explicit ``jax.random``
keys (``repro.hwmodel.faults``).  The machine with the card has no JAX, so
the port carries its own copy of the semantics those draws use, with the
same bits:

* keys are threefry-2x32 key pairs; :func:`PRNGKey` packs a seed as JAX does
  (high word 0 for a 32-bit seed, low word the seed's two's complement);
* :func:`fold_in` hashes ``(0, data)`` under the key, :func:`split` hashes the
  counters ``(0, i)``;
* random bits use the *partitionable* counter layout (JAX's default from
  0.5 on): element ``i`` of a draw hashes the 64-bit counter ``i`` split into
  ``(hi, lo)`` words, and its 32 bits are the XOR of the two output words;
* :func:`uniform` puts the top 23 bits in the mantissa of ``[1, 2)`` and
  subtracts one; :func:`normal` is ``sqrt(2) * erfinv(u)`` with ``u`` uniform
  over ``[nextafter(-1, 0), 1)`` and XLA's float32 ``erfinv`` polynomial
  (M. Giles, "Approximating the erfinv function").

torch has no full ``uint32`` arithmetic, so words live in ``int64`` tensors
(or Python ints, for key derivation) masked to 32 bits.  Integer results are
exact on any device.  The float parts must be too, so that the CPU and the
card draw the same realization: the transcendentals (``log1p`` inside
``erfinv``, and the ``exp`` of the fault layer) are :func:`log1p64` /
:func:`exp64`, float64 series built from additions, multiplications,
divisions and exponent-bit arithmetic only, each a separate IEEE-rounded
op, rounded once to float32 by the caller (the math libraries promise no
identical last bit across devices); ``sqrt`` goes through float64, since
the card's float32 ``sqrt`` is not correctly rounded for every input.
Against XLA's float32 ``log1p`` a normal draw may differ by a few float32
ulps (``tests/test_torch_faults.py`` holds the bound).
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

Key = Tuple[int, int]
Word = Union[int, torch.Tensor]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_SQRT2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32).item()
_NEXT_BELOW_ONE = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()

_LN2_HI = 6.93147180369123816490e-01  # ln 2 split (fdlibm): k * _LN2_HI is exact
_LN2_LO = 1.90821492927058770002e-10
_INV_LN2 = 1.44269504088896338700e+00
_EXP_TAYLOR = tuple(1.0 / math.factorial(n) for n in range(14))  # |r| <= ln2/2: < 1e-17
_LOG_ODD = tuple(1.0 / (2 * j + 1) for j in range(12))  # |s| <= 0.172: < 1e-19

# XLA's float32 erfinv coefficients, highest order first
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(key: Key, x1: Word, x2: Word) -> Tuple[Word, Word]:
    """The threefry-2x32 block cipher (20 rounds) of counter words
    ``(x1, x2)`` under ``key``; Python ints or int64 tensors of 32-bit words."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & M32
    return x1, x2


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in the int32 range."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed must fit in int32 (as JAX takes it by default), got {seed}")
    return (0, seed & M32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    return threefry2x32(key, 0, int(data) & M32)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)``."""
    return tuple(threefry2x32(key, 0, i) for i in range(num))


def random_bits(key: Key, shape, device=None) -> torch.Tensor:
    """32 random bits per element (int64 holding the uint32 value)."""
    shape = tuple(shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key, idx >> 32, idx & M32)
    return (b1 ^ b2).reshape(shape)


def uniform(key: Key, shape, device=None, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 over ``[minval, maxval)``."""
    bits = random_bits(key, shape, device)
    mant = (bits >> 9) | 0x3F800000  # exponent of 1.0: a float in [1, 2)
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """``2.0 ** k`` (float64) for integer ``k`` in [-1022, 1023], from its bits."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def exp64(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of a float64 tensor (|x| < 700): ``2^k * exp(r)`` with
    ``r = x - k ln2`` and a degree-13 Taylor polynomial; device-independent."""
    x = x.double()
    k = torch.round(x * _INV_LN2)
    r = (x - k * _LN2_HI) - k * _LN2_LO
    p = torch.full_like(r, _EXP_TAYLOR[-1])
    for c in reversed(_EXP_TAYLOR[:-1]):
        p = p * r + c
    return p * _pow2(torch.clamp(k, -1022, 1023))


def log1p64(y: torch.Tensor) -> torch.Tensor:
    """``log(1 + y)`` of a float64 tensor (y > -1), device-independent:
    ``log z`` of ``z = 1 + y`` as ``e ln2 + 2 atanh((m-1)/(m+1))`` with
    ``m`` in [sqrt(1/2), sqrt(2)), corrected by ``y / (z - 1)`` for the
    rounding of ``z`` (``log1p(y) = y`` when ``z`` rounds to 1)."""
    y = y.double()
    z = 1.0 + y
    bits = z.contiguous().view(torch.int64)
    e = (bits >> 52) - 1023
    m = ((bits & ((1 << 52) - 1)) | (1023 << 52)).view(torch.float64)  # [1, 2)
    big = m > math.sqrt(2.0)
    m = torch.where(big, m * 0.5, m)
    e = (e + big.to(torch.int64)).double()
    s = (m - 1.0) / (m + 1.0)
    s2 = s * s
    p = torch.full_like(s, _LOG_ODD[-1])
    for c in reversed(_LOG_ODD[:-1]):
        p = p * s2 + c
    log_z = e * _LN2_HI + (2.0 * s * p + e * _LN2_LO)
    zm1 = z - 1.0
    return torch.where(zm1 == 0.0, y, log_z * (y / torch.where(zm1 == 0.0, 1.0, zm1)))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erfinv``.  ``log1p`` and each Horner step (a fused
    multiply-add, as XLA's CPU code contracts it) are evaluated in float64
    and rounded once to float32: float64 products of float32 values are
    exact, so every device gives the same bits."""
    w = -log1p64(-(x * x).double()).float()
    small = w < 5.0
    # float32 sqrt through float64 (correctly rounded either way; the card's
    # float32 sqrt is not, for some inputs)
    w = torch.where(small, w - 2.5, torch.sqrt(w.double()).float() - 3.0).double()
    p = None
    for cs, cl in zip(_ERFINV_SMALL, _ERFINV_LARGE):
        c = torch.where(small, torch.tensor(cs, dtype=torch.float32, device=x.device),
                        torch.tensor(cl, dtype=torch.float32, device=x.device)).double()
        p = c if p is None else (c + p * w).float().double()
    edge = torch.where(x > 0, torch.inf, -torch.inf).to(torch.float32)  # erfinv(+-1)
    return torch.where(x.abs() == 1.0, edge, p.float() * x)


def normal(key: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32."""
    u = uniform(key, shape, device, _NEXT_BELOW_ONE, 1.0)
    return erfinv(u) * _SQRT2
