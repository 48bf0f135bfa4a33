"""ssd_scan — the SSD chunk scan of the mamba2 mixer, the wrapper of the CUDA
C++ kernels in ``csrc/ssd_scan.cu`` (port of
``repro.kernels.ssd_scan.kernel.ssd_scan_pallas``).

xdt ``[B, T, H, P]`` and a ``[B, T, H]`` float32, B/C ``[B, T, N]`` float32
or bfloat16 (G=1: shared by every head); returns ``(y [B, T, H, P], final
state [B, H, N, P])`` float32, the scan starting from a zero state.  B and C
are read in their own type with any batch and time strides (the mixer passes
slices of the conv output), so the wrapper makes no float32 copy; every
input that holds elements needs a contiguous last dimension.

One call is three launches on the current stream (chunk state, state
passing, chunk output) through one C entry, counted once.  The wrapper
allocates their float32 workspace from shapes alone: ``ws [B, nc, H, N,
P]`` (each chunk's state contribution, then the state entering it) and
``cas [B, nc, H, Qp]`` (each chunk's cumsum of a), nc = ceil(T / chunk);
the C entry groups the chunk-scan kernel's heads for about one CTA per SM.
A chunk over ``MAX_CHUNK`` rows, or a state over ``MAX_STATE`` rows (the
tiles would not fit a CTA's shared memory), is refused before anything
launches.  On a CPU tensor the plain version (``ref.ssd_scan_ref``) runs
instead.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

SOURCE = Path(__file__).parent / "csrc" / "ssd_scan.cu"
BC_TYPES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES = _cuda.launch_counter("ssd_scan")

# limits of csrc/ssd_scan.cu (a test reads them back from the source)
QPAD = 64  # chunk rows padded to a multiple of this in the cumsum workspace
MAX_CHUNK = 128  # rows of y: one 16-row tile for each of 8 warps
MAX_STATE = 144  # state rows whose tiles fit a CTA's shared memory beside MAX_CHUNK


def workspace_shapes(b: int, t: int, h: int, p: int, n: int, chunk: int):
    """Shapes of the float32 workspace ``(ws, cas)`` of one call."""
    nc = -(-t // chunk)
    return (b, nc, h, n, p), (b, nc, h, -(-chunk // QPAD) * QPAD)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = [p] * 8 + [ll] * 9 + [i] * 7 + [p]
    lib.ssd_scan_launch.restype = i


def ssd_scan(
    xdt: torch.Tensor,
    a: torch.Tensor,
    bmat: torch.Tensor,
    cmat: torch.Tensor,
    *,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD over ``chunk``-step chunks: ``(y, final state)``.  Raises
    ``KernelGradError`` where autograd would differentiate it."""
    _cuda.refuse_grad("ssd_scan", xdt, a, bmat, cmat)
    if xdt.dim() != 4 or a.shape != xdt.shape[:3]:
        raise ValueError(f"xdt must be [B, T, H, P] and a [B, T, H], got "
                         f"{tuple(xdt.shape)} / {tuple(a.shape)}")
    if bmat.dim() != 3 or bmat.shape != cmat.shape or bmat.shape[:2] != xdt.shape[:2]:
        raise ValueError(f"B/C must be [B, T, N] matching xdt, got "
                         f"{tuple(bmat.shape)} / {tuple(cmat.shape)}")
    if chunk <= 0:
        raise ValueError(f"chunk must be > 0, got {chunk}")
    if not _cuda.on_card(xdt):
        return ssd_scan_ref(xdt, a, bmat, cmat, chunk=chunk)
    return _launch(xdt, a, bmat, cmat, chunk)


def _launch(xdt, a, bmat, cmat, chunk) -> Tuple[torch.Tensor, torch.Tensor]:
    b, t, h, p = xdt.shape
    n = bmat.shape[2]
    if xdt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"ssd_scan kernel takes float32 xdt and a, got {xdt.dtype} / {a.dtype}")
    if bmat.dtype not in BC_TYPES or cmat.dtype != bmat.dtype:
        raise ValueError(f"ssd_scan kernel takes float32 or bfloat16 B/C of one type, "
                         f"got {bmat.dtype} / {cmat.dtype}")
    for name, x in (("xdt", xdt), ("a", a), ("bmat", bmat), ("cmat", cmat)):
        if x.device != xdt.device:
            raise ValueError(f"{name} is on {x.device}, xdt on {xdt.device}")
        if x.numel() and x.stride(-1) != 1:  # an empty input is never read
            raise ValueError(f"ssd_scan kernel needs a contiguous last dimension of {name}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"ssd_scan kernel takes chunks of at most {MAX_CHUNK} steps, got {chunk}")
    if n > MAX_STATE:
        raise ValueError(f"ssd_scan kernel takes a state of at most {MAX_STATE} rows (its tiles "
                         f"fill a CTA's shared memory), got {n}")
    y = torch.empty((b, t, h, p), dtype=torch.float32, device=xdt.device)
    hout = torch.empty((b, h, n, p), dtype=torch.float32, device=xdt.device)
    ws_shape, cas_shape = workspace_shapes(b, t, h, p, n, chunk)
    ws = torch.empty(ws_shape, dtype=torch.float32, device=xdt.device)
    cas = torch.empty(cas_shape, dtype=torch.float32, device=xdt.device)
    lib = _cuda.load(SOURCE, _bind)
    rc = lib.ssd_scan_launch(
        xdt.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        y.data_ptr(), hout.data_ptr(), ws.data_ptr(), cas.data_ptr(),
        *xdt.stride()[:3], *a.stride()[:2], bmat.stride(0), bmat.stride(1),
        cmat.stride(0), cmat.stride(1),
        b, t, h, p, n, chunk, BC_TYPES[bmat.dtype],
        _cuda.stream_handle(xdt.device),
    )
    _cuda.check(lib, rc, "ssd_scan")
    LAUNCHES.add()
    return y, hout
