"""Service layer: load / embed / detect, the pattern codec, the ECC
message layer, desync-robust detection and streaming localization."""

from aware_tpu_torch.service.api import (
    AWAREDetector,
    AWAREEmbedder,
    detect_watermark,
    detect_watermark_batch,
    embed_watermark,
    embed_watermark_batch,
    load,
)
from aware_tpu_torch.service.codec import decode_pattern, encode_pattern
from aware_tpu_torch.service.ecc import (
    decode_message,
    decode_message_windows,
    detect_message,
    detect_message_robust,
    embed_message,
    encode_message,
)
from aware_tpu_torch.service.robust import detect_watermark_robust
from aware_tpu_torch.service.streaming import (
    StreamingDetector,
    StreamingResult,
    detect_watermark_streaming,
)

__all__ = [
    "detect_watermark_robust",
    "AWAREEmbedder",
    "AWAREDetector",
    "load",
    "embed_watermark",
    "detect_watermark",
    "embed_watermark_batch",
    "detect_watermark_batch",
    "encode_pattern",
    "decode_pattern",
    "encode_message",
    "decode_message",
    "decode_message_windows",
    "embed_message",
    "detect_message",
    "detect_message_robust",
    "StreamingDetector",
    "StreamingResult",
    "detect_watermark_streaming",
]
