"""``repro_torch.ops`` — the op dispatch layer of the port.

Frozen specs (:class:`SoftmaxSpec`, :class:`AttentionSpec`,
:class:`PagedAttentionSpec`, :class:`MatmulSpec`, :class:`ScanSpec`) describe
an invocation; a capability-checked registry maps ``(op, impl)`` to a
backend; :func:`softmax`, :func:`attention`, :func:`paged_attention`,
:func:`matmul` and :func:`ssd_scan` dispatch through it, and :func:`use`
retargets every dispatch in a block.  A :class:`FaultModel` in a spec injects seeded RRAM
non-idealities; an :class:`AccuracyGuard` (``guard=`` on :func:`softmax` and
:func:`matmul`) holds a degraded backend to the exact oracle and falls back
to a clean one.

The impl names are the JAX reference's, so a config means the same in both
packages.  What each runs here:

* ``reference`` — the plain PyTorch engines in ``core`` (materialized
  scores; paged: gather adapter + materialized attention).
* ``xla`` — the plain online-blocked loop (paged: gather adapter + it);
  a faulty attention call takes the materialized ``reference`` path;
  softmax ``xla`` is ``torch.softmax`` (exact kind only); matmul ``xla``
  is ``torch.matmul``.
* ``pallas`` — the hand-written Hopper kernels: attention runs the CUDA
  ``flash_star`` kernel, softmax the CUDA STAR row softmax (one cluster of
  CTAs a row, every mode, clean or faulty), paged
  ``pallas`` the gather adapter + ``flash_star``.  The attention kernels
  refuse a fault, as the reference's do.
* ``pallas_paged`` — the gather-free CUDA paged decode kernel
  (:func:`paged_gather_bytes` counts the pool bytes each route reads).
* ``hwmodel`` (matmul) — the RRAM crossbar model through the CUDA crossbar
  kernel.
* ssd_scan ``pallas`` — the CUDA SSD chunk-scan kernel; ``reference`` — the
  mamba2 mixer's plain chunked scan.

A kernel backend launches its kernel on CUDA tensors and runs the kernel's
plain version on CPU tensors.
"""

from repro_torch.hwmodel.faults import FaultModel  # noqa: F401
from repro_torch.kernels.crossbar_matmul.ref import CrossbarSpec  # noqa: F401
from repro_torch.ops.dispatch import (  # noqa: F401
    DEFAULT_ATTENTION,
    DEFAULT_MATMUL,
    DEFAULT_PAGED_ATTENTION,
    DEFAULT_SOFTMAX,
    DEFAULT_SSD_SCAN,
    attention,
    matmul,
    paged_attention,
    resolve,
    softmax,
    ssd_scan,
    validate,
)
from repro_torch.ops.guard import (  # noqa: F401
    AccuracyGuard,
    GuardConfig,
    GuardTripWarning,
)
from repro_torch.ops.platform import resolve_device  # noqa: F401
from repro_torch.ops.registry import (  # noqa: F401
    Backend,
    CapabilityError,
    OpDispatchError,
    UnknownBackendError,
    backends,
    get,
    register,
    registered_ops,
    unregister,
    use,
)
from repro_torch.ops.specs import (  # noqa: F401
    AttentionSpec,
    MatmulSpec,
    PagedAttentionSpec,
    ScanSpec,
    SoftmaxSpec,
    Spec,
    resolve_precision,
    spec_json,
)

# Importing the built-in backends populates the registry.
from repro_torch.ops import impls as _impls  # noqa: E402,F401  isort: skip
from repro_torch.ops.impls import paged_gather_bytes  # noqa: E402,F401  isort: skip
