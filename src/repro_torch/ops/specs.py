"""Frozen, hashable op specs (port of ``repro.ops.specs``).

A spec says *what* to compute and *which* backend family computes it
(``impl``).  Impl names are the reference's, so a config means the same in
both packages; see ``repro_torch.ops`` for what each name runs here.
Every field of the reference is here but ``interpret`` (the port has no
interpret mode), so a spec records the same configuration and
:func:`spec_json` gives the reference's dict.  Some fields are recorded and
validated as the reference does, but no backend of the port reads them: the
Pallas tiles ``block_q`` / ``block_rows`` / ``block_m`` and ``ragged``.

Precision is a :class:`~repro_torch.core.fixedpoint.FixedPointFormat` or a
named policy ``"auto:<dataset>"`` resolved through
``repro_torch.core.precision.policy_for`` (the paper's per-dataset
calibration), as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Union

from repro_torch.core.fixedpoint import DEFAULT_FORMAT, FixedPointFormat
from repro_torch.core.kvquant import KV_DTYPES
from repro_torch.core.precision import policy_for
from repro_torch.hwmodel.faults import FaultModel
from repro_torch.kernels.crossbar_matmul.ref import DEFAULT_SPEC, CrossbarSpec

SOFTMAX_KINDS = ("star", "star_ste", "exact")
SOFTMAX_MODES = ("gather", "onehot", "histogram")

Precision = Union[FixedPointFormat, str]


def resolve_precision(precision: Precision) -> FixedPointFormat:
    """A precision field as a format: a :class:`FixedPointFormat` as it is,
    ``"auto:<dataset>"`` (e.g. ``"auto:mrpc"``) through the paper's
    per-dataset table."""
    if isinstance(precision, FixedPointFormat):
        return precision
    if isinstance(precision, str):
        if precision.startswith("auto:"):
            return policy_for(precision.split(":", 1)[1])
        raise ValueError(
            f"unknown precision policy {precision!r}: expected a "
            f"FixedPointFormat or an 'auto:<dataset>' policy name "
            f"(datasets: cnews, mrpc, cola; anything else falls back to "
            f"the default {DEFAULT_FORMAT.short_name()} format)"
        )
    raise TypeError(
        f"precision must be a FixedPointFormat or 'auto:<dataset>' string, "
        f"got {type(precision).__name__}"
    )


@dataclasses.dataclass(frozen=True)
class SoftmaxSpec:
    """One softmax invocation: engine kind, dataflow mode, precision, impl."""

    impl: str = "reference"
    kind: str = "star"  # star | star_ste | exact
    mode: str = "gather"  # gather | onehot | histogram
    precision: Precision = DEFAULT_FORMAT
    block_rows: int = 8  # the Pallas row tile: recorded, not read
    # seeded device non-idealities; a null model normalizes to None
    fault: Optional[FaultModel] = None

    op = "softmax"

    def __post_init__(self) -> None:
        if self.kind not in SOFTMAX_KINDS:
            raise ValueError(
                f"softmax kind must be one of {SOFTMAX_KINDS}, got {self.kind!r}"
            )
        if self.mode not in SOFTMAX_MODES:
            raise ValueError(
                f"softmax mode must be one of {SOFTMAX_MODES}, got {self.mode!r}"
            )
        if self.fault is not None and self.fault.is_null:
            object.__setattr__(self, "fault", None)
        if self.fault is not None and self.kind == "exact":
            raise ValueError(
                "kind='exact' is the digital FP oracle: there is no RRAM array to "
                "inject faults into; use kind='star' (or drop the fault field)"
            )
        resolve_precision(self.precision)  # fail early on a bad policy

    @property
    def fmt(self) -> Optional[FixedPointFormat]:
        """Resolved fixed-point format; ``None`` for the exact oracle."""
        return None if self.kind == "exact" else resolve_precision(self.precision)

    def tolerance(self) -> float:
        """Max-abs-error bound vs the exact softmax: ``e^r - 1`` (an ideal
        device; faults can exceed it, which the accuracy guard enforces)."""
        fmt = self.fmt
        return 1e-6 if fmt is None else math.exp(fmt.resolution) - 1.0


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """One attention invocation: masking, blocking and the softmax engine.

    ``fault`` is sugar for ``softmax=replace(softmax, fault=...)``: the
    engine's RRAM arrays live in its softmax stage, so the model folds into
    the nested spec (and wins over a fault already set there)."""

    impl: str = "xla"
    softmax: SoftmaxSpec = SoftmaxSpec()
    causal: bool = False
    sliding_window: Optional[int] = None
    ragged: bool = False  # calls pass per-row kv_valid_len: recorded, not read
    block_q: int = 128  # the Pallas query tile: recorded, not read
    block_k: int = 128  # KV block of the pallas plain version's loop
    block_kv: int = 512  # KV block of the xla loop
    pv_int8: bool = False
    fault: Optional[FaultModel] = None  # folds into .softmax

    op = "attention"

    def __post_init__(self) -> None:
        if self.sliding_window is not None and self.sliding_window <= 0:
            raise ValueError(f"sliding_window must be > 0, got {self.sliding_window}")
        for field in ("block_q", "block_k", "block_kv"):
            if getattr(self, field) <= 0:
                raise ValueError(f"{field} must be > 0, got {getattr(self, field)}")
        if self.fault is not None and self.fault.is_null:
            object.__setattr__(self, "fault", None)
        if self.fault is not None:
            object.__setattr__(
                self, "softmax", dataclasses.replace(self.softmax, fault=self.fault))


@dataclasses.dataclass(frozen=True)
class PagedAttentionSpec:
    """One paged decode invocation over a block-pool KV cache.

    ``kv_dtype`` declares the page-pool storage layout: ``"fp32"`` stores
    values; ``"int8"`` / ``"fp8_e4m3"`` store codes plus per-(block, head)
    scale pages that every call must pass as ``kv_scales``."""

    impl: str = "xla"
    softmax: SoftmaxSpec = SoftmaxSpec()
    block_size: int = 16
    block_q: int = 128  # the Pallas query tile: recorded, not read
    block_k: int = 128
    kv_dtype: str = "fp32"  # fp32 | int8 | fp8_e4m3 (core.kvquant)

    op = "paged_attention"

    def __post_init__(self) -> None:
        for field in ("block_size", "block_q", "block_k"):
            if getattr(self, field) <= 0:
                raise ValueError(f"{field} must be > 0, got {getattr(self, field)}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {self.kv_dtype!r}")


@dataclasses.dataclass(frozen=True)
class MatmulSpec:
    """One matmul invocation.

    ``impl``: ``"xla"`` (``torch.matmul``, the performance path) or
    ``"hwmodel"`` (the RRAM crossbar model: 8-bit operands on 128x128 tiles
    through a 5-bit ADC, the CUDA crossbar kernel on the card)."""

    impl: str = "xla"
    crossbar: CrossbarSpec = DEFAULT_SPEC
    ranging: str = "calibrated"  # hwmodel ADC ranging: calibrated | fullscale
    block_m: int = 128  # the Pallas row tile: recorded, not read
    fault: Optional[FaultModel] = None  # crossbar cell / ADC faults

    op = "matmul"

    def __post_init__(self) -> None:
        if self.ranging not in ("calibrated", "fullscale"):
            raise ValueError(
                f"ranging must be 'calibrated' or 'fullscale', got {self.ranging!r}")
        if self.fault is not None and self.fault.is_null:
            object.__setattr__(self, "fault", None)


@dataclasses.dataclass(frozen=True)
class ScanSpec:
    """One fused SSD chunk-scan invocation (the mamba2 mixer's prefill)."""

    impl: str = "pallas"
    chunk: int = 128

    op = "ssd_scan"

    def __post_init__(self) -> None:
        if self.chunk <= 0:
            raise ValueError(f"chunk must be > 0, got {self.chunk}")


Spec = Union[SoftmaxSpec, AttentionSpec, PagedAttentionSpec, MatmulSpec, ScanSpec]


def spec_json(spec: Spec) -> Dict[str, Any]:
    """JSON-serializable dict of a spec (benchmark emission, logging): the
    reference's dict key for key.  Its ``interpret`` (and a nested softmax
    spec's) is ``None``, "the platform decides", the only value a spec of
    the port can mean."""
    out: Dict[str, Any] = {"op": spec.op}
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        if isinstance(v, SoftmaxSpec):
            v = {**dataclasses.asdict(v), "interpret": None}
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            v = dataclasses.asdict(v)
        elif isinstance(v, tuple):
            v = list(v)
        out[f.name] = v
    out["interpret"] = None
    return out
