"""crossbar_matmul — the tiled ADC accumulation of the crossbar MatMul engine,
the wrapper of the CUDA C++ kernel ``csrc/crossbar_matmul.cu`` (port of
``repro.kernels.crossbar_matmul.kernel.crossbar_matmul_pallas``).

Takes operands already quantized and padded to tile multiples
(``ref.prepare_operands``: the ``hwmodel`` matmul backend builds them in
plain PyTorch, as the reference does outside its kernel): integer codes
``xq [M, K]`` and ``wq [K, N]`` (``wq`` float32 under faults), the ADC
``step`` and optional ``offsets`` float32 ``[K/128, N/128]``.  Codes travel
as int8 when ``spec.weight_bits <= 8`` (as the reference passes them, the
activation codes included), else as int32.  Returns float32 ``[M, N]``.  On
a CPU tensor the plain version (``ref.crossbar_accumulate_ref``) runs on the
same operands instead.  8-bit codes run on the tensor cores (s8 mma.sync
clean, three bf16 pieces of each weight under a fault), wider codes on the
kernel's scalar body.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.crossbar_matmul.ref import (
    DEFAULT_SPEC,
    CrossbarSpec,
    crossbar_accumulate_ref,
)

SOURCE = Path(__file__).parent / "csrc" / "crossbar_matmul.cu"
TILE = 128  # the kernel's crossbar tile (rows and columns)
X_TYPES = {torch.int8: 0, torch.int32: 1}
W_TYPES = {torch.int8: 0, torch.int32: 1, torch.float32: 2}
# (x, w) operand types the backend passes: 8-bit codes, codes above 8 bits,
# and either with the float32 weights of a faulty array
PAIRS = {(torch.int8, torch.int8), (torch.int8, torch.float32),
         (torch.int32, torch.int32), (torch.int32, torch.float32)}
LAUNCHES = _cuda.launch_counter("crossbar_matmul")


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.crossbar_matmul_launch.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.crossbar_matmul_launch.restype = i


def crossbar_matmul(
    xq: torch.Tensor,
    wq: torch.Tensor,
    step: torch.Tensor,
    offsets: Optional[torch.Tensor] = None,
    *,
    spec: CrossbarSpec = DEFAULT_SPEC,
) -> torch.Tensor:
    """Per 128x128 tile ``clip(round(partial / step + off), ±adc_levels) *
    step``, accumulated over the K tiles in order.  Raises ``KernelGradError``
    where autograd would differentiate it."""
    _cuda.refuse_grad("crossbar_matmul", xq, wq, step, offsets)
    m, k = xq.shape
    k2, n = wq.shape
    kt, nt = k // spec.tile_rows, n // spec.tile_cols
    if k2 != k or k % spec.tile_rows or n % spec.tile_cols:
        raise ValueError(f"operands {tuple(xq.shape)} @ {tuple(wq.shape)} are not padded "
                         f"to {spec.tile_rows}x{spec.tile_cols} tiles")
    if tuple(step.shape) != (kt, nt) or (offsets is not None and tuple(offsets.shape) != (kt, nt)):
        raise ValueError(f"step/offsets must be [{kt}, {nt}]")
    if spec.weight_bits <= 8:
        xq = xq.to(torch.int8)
        if not wq.is_floating_point():
            wq = wq.to(torch.int8)
    if not _cuda.on_card(xq):
        return crossbar_accumulate_ref(xq, wq, step, offsets, spec)
    return _launch(xq, wq, step, offsets, spec)


def _launch(xq, wq, step, offsets, spec) -> torch.Tensor:
    if (spec.tile_rows, spec.tile_cols) != (TILE, TILE):
        raise ValueError(f"crossbar kernel takes {TILE}x{TILE} tiles, got "
                         f"{spec.tile_rows}x{spec.tile_cols}")
    if (xq.dtype, wq.dtype) not in PAIRS:
        raise ValueError(f"crossbar kernel takes (x, w) types {sorted(map(str, PAIRS))}, "
                         f"got {xq.dtype} / {wq.dtype}")
    tensors = [("xq", xq), ("wq", wq), ("step", step)]
    if offsets is not None:
        tensors.append(("offsets", offsets))
    for name, t in tensors:
        if t.device != xq.device:
            raise ValueError(f"{name} is on {t.device}, xq on {xq.device}")
        if not t.is_contiguous():
            raise ValueError(f"crossbar kernel needs contiguous {name}")
    for name, t in tensors[2:]:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    for name, t in tensors[:2]:
        if t.data_ptr() % 16:
            raise ValueError(f"crossbar kernel copies 16-byte pieces: needs a 16-byte "
                             f"aligned {name}")
    m, k = xq.shape
    n = wq.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    lib = _cuda.load(SOURCE, _bind)
    rc = lib.crossbar_matmul_launch(
        xq.data_ptr(), wq.data_ptr(), step.data_ptr(),
        offsets.data_ptr() if offsets is not None else None, out.data_ptr(),
        m, k, n, X_TYPES[xq.dtype], W_TYPES[wq.dtype], spec.adc_levels,
        _cuda.stream_handle(xq.device),
    )
    _cuda.check(lib, rc, "crossbar_matmul")
    LAUNCHES.add()
    return out
