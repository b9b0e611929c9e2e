"""Audio quality and detection metrics (the port of ``aware_tpu/metrics``)."""

from aware_tpu_torch.metrics.audio import (
    BER,
    PESQ,
    SNR,
    STOI,
    ber,
    pesq,
    pesq_proxy,
    snr,
    stoi,
    stoi_device,
)
from aware_tpu_torch.metrics.pesq_p862 import pesq_wb
from aware_tpu_torch.metrics.stoi_exact import stoi_exact

__all__ = [
    "BER", "SNR", "STOI", "PESQ",
    "ber", "snr", "stoi", "stoi_device", "stoi_exact",
    "pesq", "pesq_wb", "pesq_proxy",
]
