"""Plain PyTorch version of the SSD chunk-scan kernel.

It is the model's own chunked SSD (``repro_torch.models.ssm``), called with
the kernel's convention: per-head inputs, inclusive-cumsum decay, G=1 (B/C
shared across heads).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_scan_ref(
    xdt: torch.Tensor,  # [B, T, H, P] (x pre-multiplied by dt)
    a: torch.Tensor,  # [B, T, H] negative log-decay
    bmat: torch.Tensor,  # [B, T, N]
    cmat: torch.Tensor,  # [B, T, N]
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,  # [B, H, N, P]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y [B,T,H,P], final state [B,H,N,P])``, both float32."""
    # imported at call time: the models import the ops layer, whose
    # backends import this module
    from repro_torch.models.ssm import _ssd_chunk_scan

    return _ssd_chunk_scan(xdt, a, bmat, cmat, h0, chunk)
