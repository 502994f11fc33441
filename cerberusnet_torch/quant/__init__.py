from cerberusnet_torch.quant.ptq import (
    calibrate,
    quant_interception,
    quantization_error,
    quantize,
    quantized_apply,
)
from cerberusnet_torch.quant.qat import (
    finalize,
    init_ema,
    qat_apply,
    qat_interception,
    update_ema,
)

__all__ = [
    "calibrate",
    "quantize",
    "quantized_apply",
    "quant_interception",
    "quantization_error",
    "qat_apply",
    "qat_interception",
    "init_ema",
    "update_ema",
    "finalize",
]
