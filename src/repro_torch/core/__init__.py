"""AMS-Quant core in PyTorch: formats, RTN, mantissa sharing, packing, the
quantized linear layer, AMS-KV (port of src/repro/core)."""

from .ams import ams_quantize, share_mantissa  # noqa: F401
from .formats import (  # noqa: F401
    FORMATS,
    SCHEMES,
    AMSFormat,
    FPFormat,
    code_to_value,
    get_format,
    get_scheme,
)
from .packing import PackedWeight, PackLayout, make_layout, pack, unpack  # noqa: F401
from .policy import QuantPolicy  # noqa: F401
from .qlinear import QuantizedLinear, apply, dequantize_weight, quantize_linear  # noqa: F401
from .rtn import channel_scales, quantize_rtn  # noqa: F401
