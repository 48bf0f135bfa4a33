"""``repro_torch.ops`` — the op dispatch layer of the port.

Frozen specs (:class:`SoftmaxSpec`, :class:`AttentionSpec`,
:class:`PagedAttentionSpec`) describe an invocation; a capability-checked
registry maps ``(op, impl)`` to a backend; :func:`softmax`,
:func:`attention` and :func:`paged_attention` dispatch through it, and
:func:`use` retargets every dispatch in a block.

The impl names are the JAX reference's, so a config means the same in both
packages.  What each runs here:

* ``reference`` — the plain PyTorch engines in ``core`` (materialized
  scores; paged: gather adapter + materialized attention).
* ``xla`` — the plain online-blocked loop (paged: gather adapter + it);
  softmax ``xla`` is ``torch.softmax`` (exact kind only).
* ``pallas`` — the hand-written Hopper kernel: attention runs the CUDA
  ``flash_star`` kernel, softmax the Triton STAR row softmax, paged
  ``pallas`` the gather adapter + ``flash_star``.
* ``pallas_paged`` — the gather-free CUDA paged decode kernel.

A kernel backend launches its kernel on CUDA tensors and runs the kernel's
plain version on CPU tensors.
"""

from repro_torch.ops.dispatch import (  # noqa: F401
    DEFAULT_ATTENTION,
    DEFAULT_PAGED_ATTENTION,
    DEFAULT_SOFTMAX,
    attention,
    paged_attention,
    resolve,
    softmax,
    validate,
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
    use,
)
from repro_torch.ops.specs import (  # noqa: F401
    AttentionSpec,
    PagedAttentionSpec,
    SoftmaxSpec,
)

# Importing the built-in backends populates the registry.
from repro_torch.ops import impls as _impls  # noqa: E402,F401  isort: skip
