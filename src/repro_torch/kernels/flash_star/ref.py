"""Plain PyTorch version of the flash_star kernel (heads-major layout).

The same online form the kernel computes — a loop over KV blocks carrying
the int32 grid max, the denominator and the accumulator — through
``core.attention.blocked_attention``; with ``pv_int8`` the P.V product of
each ``block_k`` block in int8 as the kernel's variant computes it.

``split_bf16x3`` is the plain copy of how the bfloat16 kernel splits P
for P.V on the tensor cores without rounding P to bf16, ``split_tf32`` of
how the float32 kernel splits every operand into two tf32 pieces (3xTF32),
and ``quantize_v_blocks`` / ``v8_layout`` of the int8 variant's V pre-pass:
the codes and scales per block, and the k order in which the kernel reads
them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import SoftmaxConfig, blocked_attention
from repro_torch.core.fixedpoint import DEFAULT_FORMAT, FixedPointFormat

V8_GROUP = 32  # keys per k-group of the int8 variant's codes (one s8 mma step)


def flash_star_ref(
    q: torch.Tensor,  # [B, Hq, Tq, D]
    k: torch.Tensor,  # [B, Hkv, Tk, D]
    v: torch.Tensor,  # [B, Hkv, Tk, D]
    info: torch.Tensor,  # int32 [1 + B]: [q_offset, kv_valid per batch]
    *,
    fmt: Optional[FixedPointFormat],
    causal: bool = True,
    sliding_window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    block_k: int = 128,
    pv_int8: bool = False,
) -> torch.Tensor:
    softmax = (
        SoftmaxConfig(kind="exact") if fmt is None
        else SoftmaxConfig(kind="star", fmt=fmt)
    )
    out = blocked_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        softmax=softmax,
        causal=causal,
        sliding_window=sliding_window,
        q_offset=info[0],
        kv_valid_len=info[1:],
        scale=sm_scale,
        block_size=block_k,
        pv_int8=pv_int8,
    )
    return out.transpose(1, 2)


def flash_star_blocked_ref(
    q: torch.Tensor,  # [B, Tq, Hq, D]
    k: torch.Tensor,  # [B, Tk, Hkv, D]
    v: torch.Tensor,
    *,
    fmt: Optional[FixedPointFormat] = DEFAULT_FORMAT,
    causal: bool = True,
    sliding_window: Optional[int] = None,
    q_offset=0,
    kv_valid_len=None,
    sm_scale: Optional[float] = None,
    block_size: int = 128,
) -> torch.Tensor:
    """The online blocked reference in the reference's ``[B, T, H, D]``
    layout: ``blocked_attention`` over KV blocks of ``block_size`` rows,
    the TPU kernel's schedule at ``block_k == block_size``."""
    softmax = (
        SoftmaxConfig(kind="exact") if fmt is None
        else SoftmaxConfig(kind="star", fmt=fmt)
    )
    return blocked_attention(
        q, k, v, softmax=softmax, causal=causal, sliding_window=sliding_window,
        q_offset=q_offset, kv_valid_len=kv_valid_len, scale=sm_scale,
        block_size=block_size,
    )


def split_bf16x3(p: torch.Tensor):
    """float32 ``p`` as three bfloat16 pieces, as the bf16 kernel splits it:
    ``hi = bf16(p)``, ``mid = bf16(p - hi)``, ``lo = bf16((p - hi) - mid)``
    (round to nearest even; both differences are exact in float32).  For
    ``p >= 2**-100`` the pieces sum to ``p`` exactly (each piece holds 8 of
    its 24 significant bits); below that ``lo`` may fall among the bf16
    subnormals and ``|p - (hi + mid + lo)| <= 2**-134``, half their spacing."""
    p = p.float()
    hi = p.to(torch.bfloat16)
    rest = p - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return hi, mid, lo



def split_tf32(x: torch.Tensor):
    """float32 ``x`` as two tf32 values in float32, as the float32 kernel
    splits it: ``hi = tf32(x)``, ``lo = tf32(x - hi)``, each rounded to a
    10-bit mantissa to nearest with ties away from zero (``cvt.rna``,
    emulated on the float32 bits)."""

    def rna(t):
        bits = t.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(x)
    return hi, rna(x.float() - hi)


def quantize_v_blocks(v: torch.Tensor, bk: int):
    """The int8 variant's V per block of ``bk`` rows, as the TPU kernel
    quantizes it: ``vamax = max(max |v|, 1e-6)`` over the block's rows inside
    Tk, codes ``round(v * (127 / vamax))`` (half to even; both divisions
    IEEE, tensor by tensor, as ``core.attention.blocked_attention`` forms
    them).  Returns int8 codes ``[B, Hkv, nblk * bk, D]`` (zero past Tk) and
    the float32 scales ``vamax / 16129`` ``[B, Hkv, nblk]``."""
    b, h, tk, d = v.shape
    nblk = -(-tk // bk)
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, nblk * bk - tk))
    blocks = vf.reshape(b, h, nblk, bk, d)
    vamax = blocks.abs().amax(dim=(3, 4)).clamp(min=1e-6)
    vq = torch.full_like(vamax, 127.0) / vamax
    codes = torch.round(blocks * vq[..., None, None]).to(torch.int8)
    scales = vamax / torch.full_like(vamax, 16129.0)
    return codes.reshape(b, h, nblk * bk, d), scales


def v8_perm() -> torch.Tensor:
    """The key each logical k of a 32-key group stands for in the kernel's
    s8 P.V: logical ``16 h + 4 t + i`` is key ``16 h + 8 (i // 2) + 2 t + i % 2``,
    the keys whose scores lane ``t`` of a warp holds in its accumulator
    registers, so it packs its own p8 into the A fragment as they are."""
    k = torch.arange(V8_GROUP)
    h, t, i = k // 16, (k // 4) % 4, k % 4
    return 16 * h + 8 * (i // 2) + 2 * t + i % 2


def v8_layout(codes: torch.Tensor, bk: int) -> torch.Tensor:
    """``quantize_v_blocks``'s codes ``[B, Hkv, nblk * bk, D]`` in the
    kernel's workspace layout ``[B, Hkv, nblk, D, kpad]``: each block's
    feature rows k-contiguous, padded with zero codes to ``kpad`` (``bk``
    rounded up to 32), each 32-key group in ``v8_perm`` order."""
    b, h, rows, d = codes.shape
    nblk = rows // bk
    kpad = -(-bk // V8_GROUP) * V8_GROUP
    blocks = torch.nn.functional.pad(codes.reshape(b, h, nblk, bk, d), (0, 0, 0, kpad - bk))
    order = (torch.arange(0, kpad, V8_GROUP)[:, None] + v8_perm()[None, :]).reshape(-1)
    return blocks[:, :, :, order, :].transpose(3, 4).contiguous()
