"""paged_flash — gather-free paged decode attention, the wrapper of the CUDA
C++ kernel ``csrc/paged_attention.cu`` (port of
``repro.kernels.paged_attention.kernel.paged_flash_attention``, fp-KV and
quantized pools).

Layout as in the reference: q ``[S, Hq, D]`` (one decode token per slot),
pools ``[N, bs, Hkv, D]`` (block 0 is scratch), ``block_tables`` int32
``[S, W]``, ``kv_valid`` int32 ``[S]``.  With ``k_scale`` / ``v_scale``
(float32 ``[N, Hkv]``) the pools hold int8 or fp8_e4m3 codes and the kernel
dequantizes each page as it loads it (``code * scale[page, head]``, the
expression of ``core.kvquant.decode``).  On a CUDA tensor the pools, scale
pages and tables go to the kernel untouched — the wrapper builds no gathered
or dequantized view.  On a CPU tensor the plain gather version
(``ref.paged_attention_ref``) runs instead.  The fp and quantized variants
count their launches apart (``paged_attention``, ``paged_attention_quant``).

The kernel is split-KV: each slot's rows are cut at fixed offsets into
splits of ``SPLIT_ROWS`` rows (L, for every block size), one CTA per (slot,
KV head, split), and a combine kernel merges the splits.  The number of
splits, ``ceil(W * bs / L)``, and the float32 workspace of the partials
(``[S, Hkv, splits, G, D]`` plus ``[S, Hkv, splits, G]`` for each of m and
l) come from shapes alone: the wrapper never reads ``kv_valid`` back from
the card.  One library call per
wrapper call launches both kernels (the combine only when there is more
than one split).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.fixedpoint import FixedPointFormat
from repro_torch.kernels import _cuda
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

SOURCE = Path(__file__).parent / "csrc" / "paged_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CODE_DTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}
MAX_GROUP = 16
MAX_BLOCK_SIZE = 128
SPLIT_ROWS = 64  # L, a split's rows: the kernel's SPLIT_ROWS
LAUNCHES = _cuda.launch_counter("paged_attention")
LAUNCHES_QUANT = _cuda.launch_counter("paged_attention_quant")


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_launch.argtypes = [p] * 7 + [i] * 7 + [f, f, i, p] + [p, i]
    lib.paged_attention_launch.restype = i
    lib.paged_attention_quant_launch.argtypes = [p] * 9 + [i] * 8 + [f, f, i, p] + [p, i]
    lib.paged_attention_quant_launch.restype = i


def num_splits(w: int, bs: int) -> int:
    """Splits of ``SPLIT_ROWS`` rows that cover a table of ``w`` blocks of
    ``bs`` (one for an empty table: it writes the zeros of its free slots)."""
    return max(1, -(-(w * bs) // SPLIT_ROWS))


def paged_flash_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    kv_valid: torch.Tensor,
    *,
    fmt: Optional[FixedPointFormat],  # None -> exact online softmax
    sm_scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather-free paged decode attention.  Returns ``[S, Hq, D]``."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if q.shape[1] % k_pages.shape[2] != 0:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {q.shape[1]} % {k_pages.shape[2]}")
    if not _cuda.on_card(q):
        return paged_attention_ref(
            q, k_pages, v_pages, block_tables, kv_valid, fmt=fmt, sm_scale=sm_scale,
            k_scale=k_scale, v_scale=v_scale,
        )
    return _launch(q, k_pages, v_pages, block_tables, kv_valid, fmt, sm_scale,
                   k_scale, v_scale)


def _launch(q, k_pages, v_pages, block_tables, kv_valid, fmt, sm_scale,
            k_scale, v_scale) -> torch.Tensor:
    s, hq, d = q.shape
    n, bs, hkv, _ = k_pages.shape
    w = block_tables.shape[1]
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != d:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"paged kernel takes a GQA group of at most {MAX_GROUP}, got {hq // hkv}")
    if bs > MAX_BLOCK_SIZE:
        raise ValueError(f"paged kernel takes block_size <= {MAX_BLOCK_SIZE}, got {bs}")
    quant = k_scale is not None
    if q.dtype not in DTYPES or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"paged kernel takes float32/bfloat16 q and K/V pools of one "
                         f"type, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if quant and k_pages.dtype not in CODE_DTYPES:
        raise ValueError(f"scaled pools hold int8 or float8_e4m3fn codes, got {k_pages.dtype}")
    if not quant and k_pages.dtype != q.dtype:
        raise ValueError(f"unscaled pools hold q's type {q.dtype}, got {k_pages.dtype}")
    scales = ()
    if quant:
        scales = (("k_scale", k_scale), ("v_scale", v_scale))
        for name, t in scales:
            if t.dtype != torch.float32 or t.shape != (n, hkv):
                raise ValueError(f"{name} must be float32 [{n}, {hkv}], got "
                                 f"{t.dtype} {tuple(t.shape)}")
    if block_tables.shape != (s, w) or kv_valid.shape != (s,):
        raise ValueError(f"tables {tuple(block_tables.shape)} / kv_valid "
                         f"{tuple(kv_valid.shape)} do not match {s} slots")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("kv_valid", kv_valid), *scales):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged kernel needs a contiguous {name}")
    if block_tables.dtype != torch.int32 or kv_valid.dtype != torch.int32:
        raise ValueError("block_tables and kv_valid must be int32")
    if not q.is_contiguous():
        raise ValueError("paged kernel needs a contiguous q")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged kernel copies 16-byte pieces: it needs a 16-byte "
                             f"aligned {name}, got data_ptr % 16 = {t.data_ptr() % 16}; "
                             f"pass a contiguous copy")
    splits = num_splits(w, bs)
    out = torch.empty((s, hq, d), dtype=q.dtype, device=q.device)
    ws = None
    if splits > 1:
        ws = torch.empty(s * hq * splits * (d + 2), dtype=torch.float32, device=q.device)
    lut = _cuda.device_lut(fmt, q.device) if fmt is not None else None
    lib = _cuda.load(SOURCE, _bind)
    common = (
        float(d ** -0.5 if sm_scale is None else sm_scale),
        float(fmt.scale) if fmt is not None else 1.0,
        fmt.num_levels if fmt is not None else 0,
        _cuda.stream_handle(q.device),
        ws.data_ptr() if ws is not None else None, splits,
    )
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(),
            block_tables.data_ptr(), kv_valid.data_ptr(),
            lut.data_ptr() if lut is not None else None)
    if quant:
        rc = lib.paged_attention_quant_launch(
            *ptrs, k_scale.data_ptr(), v_scale.data_ptr(),
            s, hq, hkv, w, bs, d, DTYPES[q.dtype], CODE_DTYPES[k_pages.dtype], *common)
        _cuda.check(lib, rc, "paged_attention_quant")
        LAUNCHES_QUANT.add()
    else:
        rc = lib.paged_attention_launch(
            *ptrs, s, hq, hkv, w, bs, d, DTYPES[q.dtype], *common)
        _cuda.check(lib, rc, "paged_attention")
        LAUNCHES.add()
    return out
