"""Quantized KV block storage: per-block, per-head scales (port of the
reference's ``repro.core.kvquant``).

Cache pages hold low-bit codes (``int8`` or ``fp8_e4m3``) and a float32
scale per (block, kv_head) restores them.  One scale row per block id, so a
scale shares its block's lifecycle: allocate, free, CoW copy and prefix
sharing all move it with the block.

Symmetric absmax quantization:

* ``int8``      — ``scale = absmax / 127``, codes round half to even
  (``torch.round``, as ``jnp.round``) after clipping to ±127;
* ``fp8_e4m3``  — ``scale = absmax / 448``, codes rounded onto the e4m3
  grid in float32, clipped to ±448, then cast to ``float8_e4m3fn`` (the
  cast of a value already on the grid is exact; a value past ±448 would
  cast to NaN, so the clip is load-bearing);
* ``fp32``      — the identity layout: no codes, no scale pages.

Every expression is the reference's, so codes and scales are bit-exact
with it (``tests/test_torch_kvquant.py``).
"""

from __future__ import annotations

import torch

KV_DTYPES = ("fp32", "int8", "fp8_e4m3")

# largest magnitude of each code grid (int8 keeps the symmetric [-127, 127])
_QMAX = {"int8": 127.0, "fp8_e4m3": 448.0}

# scale floor: an all-zero block would stamp scale 0 and decode 0/0
_EPS = 1e-8

_STORAGE = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}


def validate_kv_dtype(kv_dtype: str) -> str:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
    return kv_dtype


def storage_dtype(kv_dtype: str) -> torch.dtype:
    """The cache-leaf dtype codes are stored in (fp32 has no code grid)."""
    validate_kv_dtype(kv_dtype)
    if kv_dtype == "fp32":
        raise ValueError("fp32 KV pages store values directly, not codes")
    return _STORAGE[kv_dtype]


def dtype_of(dtype: torch.dtype) -> str:
    """Map a cache-leaf dtype back to its ``kv_dtype`` name; any float wider
    than a code grid reads as ``"fp32"`` (the identity layout)."""
    for name, stored in _STORAGE.items():
        if dtype == stored:
            return name
    return "fp32"


def qmax(kv_dtype: str) -> float:
    validate_kv_dtype(kv_dtype)
    return _QMAX[kv_dtype]


def scale_of(absmax: torch.Tensor, kv_dtype: str) -> torch.Tensor:
    """Symmetric scale for a given absolute maximum (floored, float32)."""
    return torch.clamp(absmax.float(), min=_EPS) / _QMAX[kv_dtype]


def encode(x: torch.Tensor, scale: torch.Tensor, kv_dtype: str) -> torch.Tensor:
    """Quantize ``x`` onto the code grid using ``scale`` (broadcast); values
    outside the scale's range clip to the grid edge."""
    y = x.float() / scale
    if kv_dtype == "int8":
        return torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)
    if kv_dtype == "fp8_e4m3":
        # ulp = 2^(e-3) with e = floor(log2|y|) clipped to the normal /
        # subnormal exponent range; round half to even on that grid
        mag = torch.clamp(y.abs(), min=2.0 ** -9)
        exp = torch.clamp(torch.floor(torch.log2(mag)), -6.0, 8.0)
        ulp = torch.exp2(exp - 3.0)
        q = torch.round(y / ulp) * ulp
        return torch.clamp(q, -448.0, 448.0).to(torch.float8_e4m3fn)
    raise ValueError(f"no code grid for kv_dtype {kv_dtype!r}")


def decode(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Restore codes to float32: the one dequant expression every reader
    (kernel, gather plain version, prefix-cache staging) shares."""
    return codes.float() * scale


def quantize_blocks(x: torch.Tensor, kv_dtype: str):
    """Quantize whole blocks: ``[..., bs, H, D] -> (codes, scale[..., H])``;
    the absmax reduces over the block's rows and the head dim."""
    validate_kv_dtype(kv_dtype)
    absmax = x.float().abs().amax(dim=(-3, -1))
    scale = scale_of(absmax, kv_dtype)
    return encode(x, scale[..., None, :, None], kv_dtype), scale


def row_scale(x: torch.Tensor, kv_dtype: str) -> torch.Tensor:
    """Scale a single token row ``[..., H, D]`` would stamp: ``[..., H]``."""
    return scale_of(x.float().abs().amax(dim=-1), kv_dtype)


def indexable(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as bytes if it holds fp8 codes: gathers and scatters of
    float8 tensors are not implemented by every PyTorch build, byte copies
    are, and they move the same bits."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t
