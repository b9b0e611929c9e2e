"""Streaming service: long-form ingest and watermark localization.

The port of ``aware_tpu/service/streaming.py``: is there a watermark
anywhere in an hours-long file, where, and what does it say.  A detection
window (2 s by default) slides over the file by a hop; the windows go to
the detector in batches of ``batch_windows``; a window is a hit when its
confidence (mean |tanh readout|) clears the threshold, and hit windows
group into segments with bits voted by weight.

``threshold="auto"`` calibrates against the null: 16 synthesized
unwatermarked speech windows, threshold = mean + 6 std of their
confidences.  Grouping is bridge-and-confirm: hits at most ``merge_gap``
sub-threshold windows apart merge into one segment; a group of fewer than
``min_run`` hits is kept only when its peak clears mean + ``strong_sigma``
std (else it counts in ``rejected_segments``).

Device memory: the file stays on the host.  Each batch's windows are cut
there and sent to the device; at most ``IN_FLIGHT`` batches have been sent
and not read back, and the oldest is read back (a sync) before the next is
sent.  So the peak is that of ``IN_FLIGHT`` batches, whatever the file's
length.  (A file at another sample rate is resampled whole on the
device first.)  The mesh-global mode (``detect_global``) detects the
whole file at once, its frames split over a mesh's ``seq`` ranks
(``parallel/streaming.py``).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from aware_tpu_torch.models.detector import detect_values_batch
from aware_tpu_torch.service.api import AWAREDetector, _resample_nd
from aware_tpu_torch.service.codec import decode_pattern

# window batches whose values may still be on the device
IN_FLIGHT = 2


@dataclasses.dataclass(frozen=True)
class Segment:
    start_seconds: float
    end_seconds: float
    confidence: float
    bits: np.ndarray
    n_windows: int = 1
    # fraction of per-window bit signs that agree with the merged vote:
    # near 1.0 for genuine marks, about 0.5 for spurious runs
    bit_agreement: float = 1.0


@dataclasses.dataclass(frozen=True)
class StreamingResult:
    window_starts: np.ndarray   # (N,) seconds
    confidences: np.ndarray     # (N,)
    values: np.ndarray          # (N, n_bits) raw detector outputs
    threshold: float
    segments: list[Segment]
    rejected_segments: int = 0  # hit runs dropped by confirmation

    @property
    def detected(self) -> bool:
        return len(self.segments) > 0

    @property
    def best_bits(self) -> np.ndarray | None:
        if not self.segments:
            return None
        return max(self.segments, key=lambda s: s.confidence).bits


class StreamingDetector:
    """Sliding-window detector over a shared AWAREDetector handle."""

    def __init__(
        self,
        detector: AWAREDetector,
        window_seconds: float = 2.0,
        hop_seconds: float = 1.0,
        batch_windows: int = 64,
        threshold: float | str = "auto",
        mesh=None,
        min_run: int = 2,
        strong_sigma: float = 8.0,
        merge_gap: int = 2,
    ):
        self.detector = detector
        self.sr = detector.cfg.detection_net.sample_rate
        self.window = int(window_seconds * self.sr)
        self.hop = int(hop_seconds * self.sr)
        self.batch_windows = batch_windows
        self.mesh = mesh
        self.min_run = min_run
        self.strong_sigma = strong_sigma
        self.merge_gap = merge_gap
        if threshold == "auto":
            self.threshold = self._calibrate_null()
            self.strong_threshold = self._null_mean + strong_sigma * self._null_std
        else:
            # no null statistics: confirmation can only use the run
            # length, and a single-window run passes
            self.threshold = float(threshold)
            self.strong_threshold = float(threshold)

    def _batched(self, windows: np.ndarray) -> torch.Tensor:
        """Windows (B, window) from the host -> values (B, n_bits), left
        on the device."""
        det = self.detector
        cfg = det.cfg
        return detect_values_batch(
            det.net,
            torch.as_tensor(windows, device=det.device),
            hop_length=cfg.hop_length,
            window=cfg.window,
            win_length=cfg.win_length,
            embedding_bands=cfg.embedding_bands,
            precision=cfg.matmul_precision,
        )

    def _calibrate_null(self, n: int = 16, seed: int = 1234) -> float:
        """The threshold from the confidences of ``n`` synthesized
        unwatermarked speech windows, in one batch."""
        from aware_tpu_torch.eval.harness import synthesize_speech_clip

        wins = np.stack([
            synthesize_speech_clip(seed + i, seconds=self.window / self.sr)[: self.window]
            for i in range(n)
        ])
        conf = np.mean(np.abs(self._batched(wins).cpu().numpy()), axis=1)
        self._null_mean = float(np.mean(conf))
        self._null_std = float(np.std(conf))
        return self._null_mean + 6.0 * self._null_std

    def _values_for_windows(self, audio: np.ndarray, starts: np.ndarray) -> np.ndarray:
        """Values of every window, ``batch_windows`` at a time, with at
        most ``IN_FLIGHT`` batches sent and not yet read back."""
        out: list[np.ndarray] = []
        pending: collections.deque[torch.Tensor] = collections.deque()
        for i in range(0, len(starts), self.batch_windows):
            if len(pending) == IN_FLIGHT:
                out.append(pending.popleft().cpu().numpy())
            wins = np.stack([audio[s : s + self.window] for s in starts[i : i + self.batch_windows]])
            pending.append(self._batched(wins))
        out.extend(v.cpu().numpy() for v in pending)
        return np.concatenate(out, axis=0)

    def detect(self, audio: np.ndarray, sample_rate: int) -> StreamingResult:
        """Sliding-window localization over a mono (or averaged stereo)
        array."""
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim == 2:
            audio = audio.mean(axis=1)
        if sample_rate != self.sr:
            audio = _resample_nd(audio, sample_rate, self.sr, self.detector.device)
        if len(audio) < self.window:
            audio = np.pad(audio, (0, self.window - len(audio)))
        starts = np.arange(0, len(audio) - self.window + 1, self.hop)
        values = self._values_for_windows(audio, starts)
        conf = np.mean(np.abs(values), axis=1)

        segments: list[Segment] = []
        rejected = 0
        det = self.detector
        # group the hit windows, bridging gaps of up to merge_gap misses
        groups: list[list[int]] = []
        for idx in np.flatnonzero(conf > self.threshold):
            if groups and idx - groups[-1][-1] <= self.merge_gap + 1:
                groups[-1].append(int(idx))
            else:
                groups.append([int(idx)])
        for g in groups:
            run_conf = float(np.max(conf[g]))
            # confirmation: a short group must clear the strong bar
            if len(g) < self.min_run and run_conf < self.strong_threshold:
                rejected += 1
                continue
            # the hit windows only: bridged dips would dilute the vote
            seg_vals = values[g]
            merged = np.sum(np.sign(seg_vals) * np.abs(seg_vals), axis=0)
            bits = decode_pattern(merged, det.pattern_mode, det.threshold)
            agreement = float(np.mean(np.sign(seg_vals) == np.sign(merged)))
            segments.append(Segment(
                start_seconds=float(starts[g[0]]) / self.sr,
                end_seconds=float(starts[g[-1]] + self.window) / self.sr,
                confidence=run_conf,
                bits=bits,
                n_windows=len(g),
                bit_agreement=agreement,
            ))
        return StreamingResult(
            window_starts=starts / self.sr,
            confidences=conf,
            values=values,
            threshold=self.threshold,
            segments=segments,
            rejected_segments=rejected,
        )

    def detect_file(self, path: str) -> StreamingResult:
        """Localization over a WAV file (the host runtime's reader, or
        ``utils/io.py`` without it)."""
        from aware_tpu_torch.native import read_wav

        audio, sr = read_wav(path)
        return self.detect(audio, sr)

    def detect_global(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        """One detection over the WHOLE file, its frames split over the
        ``seq`` axis of the detector's mesh (``parallel/streaming.py``:
        per-device memory O(L / n)).  Returns the decoded bits.  A
        collective call: every rank of the mesh calls it with the file."""
        if self.mesh is None:
            raise ValueError("detect_global requires a mesh")
        from aware_tpu_torch.parallel import Mesh, streaming_detect_values

        if not isinstance(self.mesh, Mesh):
            raise TypeError(f"mesh must be an aware_tpu_torch.parallel Mesh, not {self.mesh!r}")
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim == 2:
            audio = audio.mean(axis=1)
        if sample_rate != self.sr:
            audio = _resample_nd(audio, sample_rate, self.sr, self.mesh.device)
        values = streaming_detect_values(self.detector.net, audio, self.detector.cfg, self.mesh)
        det = self.detector
        return decode_pattern(values.cpu().numpy(), det.pattern_mode, det.threshold)


def detect_watermark_streaming(
    audio: np.ndarray,
    sample_rate: int,
    detector: AWAREDetector,
    window_seconds: float = 2.0,
    hop_seconds: float = 1.0,
    threshold: float | str = "auto",
) -> StreamingResult:
    """One-call sliding-window localization (see StreamingDetector)."""
    return StreamingDetector(
        detector,
        window_seconds=window_seconds,
        hop_seconds=hop_seconds,
        threshold=threshold,
    ).detect(audio, sample_rate)
