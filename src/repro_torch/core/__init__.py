# The paper's primary contribution: the STAR softmax engine and the
# vector-grained attention pipeline, as PyTorch functions (the reference's
# ``repro.core`` exports, name for name).
from repro_torch.core.fixedpoint import (  # noqa: F401
    DEFAULT_FORMAT,
    FORMAT_CNEWS,
    FORMAT_COLA,
    FORMAT_MRPC,
    FixedPointFormat,
    dequantize,
    quantize_index,
    quantize_value,
    quantize_value_ste,
)
from repro_torch.core.lut import (  # noqa: F401
    exp_lut,
    exp_lut_int,
    histogram_counts,
    histogram_dot,
    int_lut_scale,
    lookup_gather,
    lookup_onehot,
)
from repro_torch.core.star_softmax import (  # noqa: F401
    exact_softmax,
    quantization_error,
    star_softmax,
    star_softmax_ste,
)
from repro_torch.core.attention import (  # noqa: F401
    EXACT_SOFTMAX,
    STAR_SOFTMAX,
    SoftmaxConfig,
    attention,
    blocked_attention,
)
from repro_torch.core.precision import calibrate_format, policy_for  # noqa: F401
