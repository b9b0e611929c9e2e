"""aware_tpu_torch — the PyTorch/CUDA port of the aware_tpu watermarker.

The public surface mirrors ``aware_tpu``::

    from aware_tpu_torch import load, embed_watermark, detect_watermark

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  The embed solver's iteration runs through hand-written
CUDA kernels (``csrc/*.cu``: the synthesis round trip, the reflect-pad
analysis and the fused detector, forward and VJP), built with nvcc at
first use; the attack suite's IIR filters are scan kernels
(``csrc/iir.cu``); the host runtime (WAV I/O, the GMM silence gate, the
batch loader: ``native.py``) is C++ built by g++ at first use.  This
package imports torch, numpy and the standard library (and scipy in the
host metrics and the MP3 codec's alignment); it never imports jax or
aware_tpu.  Its multi-device paths (``parallel``) run on
``torch.distributed``.
"""

from aware_tpu_torch.version import __version__

__all__ = [
    "__version__",
    "load",
    "embed_watermark",
    "detect_watermark",
    "embed_watermark_batch",
    "detect_watermark_batch",
    "embed_watermark_oneshot",
    "embed_watermark_turbo",
]


def __getattr__(name):
    # lazy, so that importing a kernel module does not pull in the service
    if name in __all__[1:]:
        from aware_tpu_torch import service

        return getattr(service, name)
    raise AttributeError(f"module 'aware_tpu_torch' has no attribute {name!r}")
