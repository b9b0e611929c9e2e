"""Public extension interfaces (typing protocols).

The port of ``aware_tpu/interfaces.py``: the same structural ``Protocol``
types, so anything matching a signature plugs into the registries and the
service layer without inheritance.  (The reference exposes torch ABCs,
reference: src/AWARE/interfaces/*.)
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class AudioProcessor(Protocol):
    """tensor -> tensor transform (reference: interfaces/audio.py:1-9)."""

    def __call__(self, data: Any) -> Any: ...


@runtime_checkable
class LossFn(Protocol):
    """(predicted, target) -> scalar (reference: interfaces/loss.py:1-22)."""

    def __call__(self, predicted: Any, target: Any) -> Any: ...


@runtime_checkable
class Metric(Protocol):
    """Callable metric (reference: interfaces/metrics.py:1-7)."""

    def __call__(self, output: Any, target: Any, *args: Any) -> float: ...


@runtime_checkable
class PatternProcessor(Protocol):
    """Watermark payload codec (reference: interfaces/watermark.py:1-8)."""

    def __call__(self, inputs: Any) -> Any: ...


@runtime_checkable
class Embedder(Protocol):
    """Clip watermarker (reference: interfaces/embedding.py:1-8)."""

    def embed(
        self, audio: np.ndarray, sample_rate: int, watermark: np.ndarray
    ) -> np.ndarray: ...


@runtime_checkable
class Detector(Protocol):
    """Clip detector (reference: interfaces/detection.py:1-14)."""

    def detect(self, audio: np.ndarray, sample_rate: int) -> np.ndarray: ...


@runtime_checkable
class AttackFn(Protocol):
    """Signal-edit attack (reference: scripts/attacks.py:16-30)."""

    name: str

    def apply(self, audio: np.ndarray, sr: int, key: Any = None) -> np.ndarray: ...
