"""Per-dataset precision policy (port of ``repro.core.precision``; numpy
only).

The paper profiles the dynamic range of attention logits per dataset on
BERT-base and picks the smallest fixed-point format that keeps accuracy.
``policy_for`` gives those formats; ``calibrate_format`` derives a format
from observed logits by the same procedure.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from repro_torch.core.fixedpoint import (
    DEFAULT_FORMAT,
    FORMAT_CNEWS,
    FORMAT_COLA,
    FORMAT_MRPC,
    FixedPointFormat,
)

_PAPER_POLICIES: Dict[str, FixedPointFormat] = {
    "cnews": FORMAT_CNEWS,
    "mrpc": FORMAT_MRPC,
    "cola": FORMAT_COLA,
}


def policy_for(dataset: str) -> FixedPointFormat:
    """The paper's calibrated format for a dataset; ``DEFAULT_FORMAT`` for
    any other name."""
    return _PAPER_POLICIES.get(dataset.lower(), DEFAULT_FORMAT)


def calibrate_format(
    z_samples,
    *,
    max_frac_bits: int = 4,
    target_max_abs_err: float = 2e-2,
    coverage: float = 0.9999,
) -> FixedPointFormat:
    """``(int_bits, frac_bits)`` from observed ``x - max`` samples (numpy
    arrays or CPU tensors).

    int_bits cover the ``coverage`` quantile of ``|z|`` (the CAM depth);
    frac_bits is the smallest count whose output error bound ``e^{r/2} - 1
    <= target_max_abs_err`` holds (``r`` the resolution), capped at
    ``max_frac_bits``."""
    z = np.asarray(z_samples, dtype=np.float64).ravel()
    z = z[np.isfinite(z)]
    if z.size == 0:
        return DEFAULT_FORMAT
    depth = float(np.quantile(np.abs(z), coverage))
    int_bits = max(1, int(math.ceil(math.log2(max(depth, 1.0) + 1.0))))
    frac_bits = max_frac_bits
    for fb in range(0, max_frac_bits + 1):
        if math.exp(2.0 ** (-fb) / 2.0) - 1.0 <= target_max_abs_err:
            frac_bits = fb
            break
    return FixedPointFormat(int_bits=int_bits, frac_bits=frac_bits)
