"""The Triton body of the STAR row softmax (``gather`` and ``onehot`` modes).

Replaces the TPU kernel ``src/repro/kernels/star_softmax/kernel.py``
(``star_softmax_pallas`` / ``_kernel``, gather mode, and its ``use_mxu_lut``
one-hot @ LUT form: a one-hot row with a single nonzero reproduces the
gathered entry bit for bit, so the function is the same).  Imported only by the
launching function in ``kernel.py``: this module needs ``triton``, which
exists only on a machine with the card.

What bounds it on the H100: bytes — one read and one write of each row
(1.57 MB for the sampling call ``[4, 49152]`` float32, 0.47 µs at
3.35 TB/s).  The TPU kernel keeps a whole row in one VMEM tile; one Triton
program cannot hold a 49152-wide row, so each program walks its row three
times in ``BLOCK``-wide chunks: the integer grid max, then the direct sum
of the LUT numerators (the same ``den`` the TPU kernel takes, not an online
rescale), then the normalized write; the second and third reads mostly hit
L2.  One program per row leaves most SMs idle at four rows; splitting a row
over several programs is later work.

Round half to even is built from ``floor`` (exact for |v| <= 2^24 after the
saturation), so the kernel needs no libdevice entry point.
"""

import triton
import triton.language as tl

# -16777216 below is core.fixedpoint.GRID_SENTINEL = -(1 << 24)


@triton.jit
def _grid(x, grid_scale):
    v = x * grid_scale
    v = tl.where(v != v, -16777216.0, v)  # NaN -> sentinel
    v = tl.minimum(tl.maximum(v, -16777216.0), 16777216.0)
    f = tl.floor(v)
    frac = v - f
    odd = (f - 2.0 * tl.floor(0.5 * f)) != 0.0
    up = (frac > 0.5) | ((frac == 0.5) & odd)
    return tl.where(up, f + 1.0, f).to(tl.int32)


@triton.jit
def star_softmax_rows(
    x_ptr, out_ptr, lut_ptr, n_cols, x_stride, out_stride, grid_scale,
    TOP: tl.constexpr, BLOCK: tl.constexpr,
):
    row = tl.program_id(0).to(tl.int64)
    x_row = x_ptr + row * x_stride
    out_row = out_ptr + row * out_stride
    offs = tl.arange(0, BLOCK)

    m = tl.full([BLOCK], -16777216, tl.int32)
    for c0 in range(0, n_cols, BLOCK):
        cols = c0 + offs
        live = cols < n_cols
        x = tl.load(x_row + cols, mask=live, other=0.0).to(tl.float32)
        j = tl.where(live, _grid(x, grid_scale), -16777216)
        m = tl.maximum(m, j)
    m_row = tl.max(m, axis=0)

    acc = tl.zeros([BLOCK], tl.float32)
    for c0 in range(0, n_cols, BLOCK):
        cols = c0 + offs
        live = cols < n_cols
        x = tl.load(x_row + cols, mask=live, other=0.0).to(tl.float32)
        k = tl.minimum(tl.maximum(m_row - _grid(x, grid_scale), 0), TOP)
        p = tl.load(lut_ptr + k, mask=live, other=0.0)
        acc += p
    den = tl.sum(acc, axis=0)

    for c0 in range(0, n_cols, BLOCK):
        cols = c0 + offs
        live = cols < n_cols
        x = tl.load(x_row + cols, mask=live, other=0.0).to(tl.float32)
        k = tl.minimum(tl.maximum(m_row - _grid(x, grid_scale), 0), TOP)
        p = tl.load(lut_ptr + k, mask=live, other=0.0)
        tl.store(out_row + cols, p / den, mask=live)
