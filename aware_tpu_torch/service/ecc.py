"""Soft-decision ECC message layer over the watermark bit slots.

The port's copy of ``aware_tpu/service/ecc.py``.  A k-bit message is
encoded by a binary linear [n, k] code (n = the detector's 20 slots) and
decoded by maximum-likelihood correlation of the detector's soft values
against all 2^k bipolar codewords, with a Bonferroni-Gaussian presence
p-value.  The generator comes from a seeded numpy search (or the shortened
Golay code), so the same (k, n) gives the same code in both packages, bit
for bit.  Everything here is host numpy but ``embed_message`` /
``detect_message`` / ``detect_message_robust``, which call the port's
service API and robust detector on the handle's device.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

__all__ = [
    "EccCode",
    "EccResult",
    "get_code",
    "encode_message",
    "decode_message",
    "decode_message_windows",
    "embed_message",
    "detect_message",
    "detect_message_robust",
]

_SEARCH_SEED = 0x0ECC
_MAX_K = 14


def _min_distance(G: np.ndarray) -> int:
    """Minimum distance of the linear code with generator G (k, n): the
    minimum weight over nonzero codewords (linearity)."""
    k, n = G.shape
    msgs = ((np.arange(1, 1 << k)[:, None] >> np.arange(k)[None, :]) & 1)
    cw = (msgs.astype(np.uint8) @ G.astype(np.uint8)) & 1
    return int(cw.sum(axis=1).min())


def _golay_generator() -> np.ndarray:
    """Systematic generator [I12 | B] of the extended binary Golay
    [24, 12, 8] code (B from the quadratic residues mod 11)."""
    qr = {0, 1, 3, 4, 5, 9}  # squares mod 11 (incl. 0 on the diagonal)
    B = np.zeros((12, 12), dtype=np.uint8)
    for i in range(11):
        for j in range(11):
            B[i, j] = 1 if ((j - i) % 11) in qr else 0
        B[i, 11] = 1
    B[11, :11] = 1
    return np.concatenate([np.eye(12, dtype=np.uint8), B], axis=1)


def _shortened_golay(k: int, n: int) -> np.ndarray | None:
    """Shortened/expurgated Golay generator for an [n, k, >=8] code.

    Shorten the [24, 12, 8] extended Golay by s = 24 - n message
    positions (drop the first s rows and columns: remaining codewords
    are exactly those with zeros there), then expurgate to the first k
    of the surviving 12 - s rows.  Any subcode keeps d >= 8.
    """
    s = 24 - n
    if not (0 <= s <= 11) or k > 12 - s:
        return None
    G = _golay_generator()
    return np.ascontiguousarray(G[s : s + k, s:])


@functools.lru_cache(maxsize=16)
def _search_generator(k: int, n: int) -> tuple[bytes, int]:
    """Deterministic generator choice maximizing minimum distance.

    Candidates: the shortened/expurgated Golay [n, k, >=8] when n, k
    admit one, plus a seeded random-systematic search.  Returns
    (G.tobytes(), d_min); cached per (k, n).  Systematic form [I_k | P]
    keeps message bits visible in the first k slots.
    """
    rng = np.random.default_rng(_SEARCH_SEED + 1009 * k + n)
    n_cand = 500 if k <= 10 else (200 if k <= 12 else 80)
    best_G, best_d = None, -1
    golay = _shortened_golay(k, n)
    if golay is not None:
        best_G, best_d = golay, _min_distance(golay)
    eye = np.eye(k, dtype=np.uint8)
    for _ in range(n_cand):
        P = rng.integers(0, 2, size=(k, n - k), dtype=np.uint8)
        G = np.concatenate([eye, P], axis=1)
        d = _min_distance(G)
        if d > best_d:
            best_G, best_d = G, d
    assert best_G is not None
    return best_G.tobytes(), best_d


@dataclasses.dataclass(frozen=True)
class EccCode:
    """A fixed [n, k] binary linear code with its bipolar ML codebook."""

    k: int
    n: int
    d_min: int
    G: np.ndarray          # (k, n) uint8 generator, systematic
    codebook: np.ndarray   # (2**k, n) float32 bipolar codewords

    def encode(self, msg_bits: np.ndarray) -> np.ndarray:
        """k message bits (0/1) -> n slot bits (0/1)."""
        m = np.asarray(msg_bits, dtype=np.uint8).reshape(-1)
        if m.size != self.k:
            raise ValueError(f"expected {self.k} message bits, got {m.size}")
        return ((m @ self.G) & 1).astype(np.int32)

    def decode(self, values: np.ndarray) -> "EccResult":
        """Soft detector values (n,) -> ML message with margin/p-value."""
        v = np.asarray(values, dtype=np.float32).reshape(-1)
        if v.size != self.n:
            raise ValueError(f"expected {self.n} soft values, got {v.size}")
        scores = self.codebook @ v                    # (2**k,)
        order = np.argsort(scores)
        best = int(order[-1])
        s1 = float(scores[best])
        s2 = float(scores[order[-2]]) if scores.size > 1 else -s1
        msg = ((best >> np.arange(self.k)) & 1).astype(np.int32)
        # Bonferroni-Gaussian tail bound on the null max-correlation:
        # under H0 each score ~ N(0, n*sigma^2) with sigma the per-slot
        # value scale; p <= 2^k * Q(s1 / (sigma*sqrt(n))).  Conservative
        # (scores are positively correlated) and approximate (values are
        # bounded tanh outputs, not Gaussian) — a presence indicator,
        # not a calibrated significance level.
        sigma = float(np.std(v)) or 1e-12
        z = s1 / (sigma * math.sqrt(self.n))
        p = min(1.0, (2.0 ** self.k) * 0.5 * math.erfc(z / math.sqrt(2.0)))
        return EccResult(
            msg_bits=msg, score=s1, margin=(s1 - s2), pvalue=p,
            slot_bits=((self.codebook[best] > 0).astype(np.int32)),
        )


@dataclasses.dataclass(frozen=True)
class EccResult:
    msg_bits: np.ndarray   # (k,) decoded message
    score: float           # ML correlation of the winner
    margin: float          # winner minus runner-up correlation
    pvalue: float          # Bonferroni presence bound (H0: no watermark)
    slot_bits: np.ndarray  # (n,) the winning codeword as 0/1 slots


@functools.lru_cache(maxsize=16)
def get_code(k: int, n: int = 20) -> EccCode:
    """The deterministic [n, k] code used by encode/decode (cached)."""
    if not (1 <= k <= min(_MAX_K, n)):
        raise ValueError(f"k must be in [1, {min(_MAX_K, n)}], got {k}")
    g_bytes, d = _search_generator(k, n)
    G = np.frombuffer(g_bytes, dtype=np.uint8).reshape(k, n)
    msgs = ((np.arange(1 << k)[:, None] >> np.arange(k)[None, :]) & 1)
    cw = (msgs.astype(np.uint8) @ G) & 1
    codebook = (2.0 * cw - 1.0).astype(np.float32)
    return EccCode(k=k, n=n, d_min=d, G=G, codebook=codebook)


def encode_message(msg_bits: np.ndarray, n_slots: int = 20) -> np.ndarray:
    """k message bits -> n_slots watermark bits for the embed path."""
    m = np.asarray(msg_bits).reshape(-1)
    return get_code(int(m.size), n_slots).encode(m)


def decode_message(
    values: np.ndarray, k: int, n_slots: int = 20
) -> EccResult:
    """Raw detector values -> ML-decoded k-bit message (+margin/p-value)."""
    return get_code(k, n_slots).decode(values)


def embed_message(audio, sample_rate, msg_bits, embedder):
    """Embed a k-bit message (k < n_slots) via the normal embed path."""
    from aware_tpu_torch.service.api import embed_watermark

    bits = encode_message(msg_bits, embedder.output_length)
    return embed_watermark(audio, sample_rate, bits, embedder)


def decode_message_windows(
    values: np.ndarray, k: int, top: int = 0
) -> EccResult:
    """ML message decode over stacked per-window detector values (N, n).

    For a mark repeated across sliding windows (service/streaming.py
    StreamingResult.values) the per-codeword correlations ADD across
    windows under independent noise, so decoding the window-summed
    values is the joint ML decision — a free integration gain over
    decoding any single window.  With ``top > 0`` only the ``top``
    windows by energy (sum |values|) are summed — use when the mark
    covers part of the stream and silent windows would dilute it.
    """
    v = np.asarray(values, dtype=np.float32)
    if v.ndim != 2:
        raise ValueError(f"expected (N, n) window values, got {v.shape}")
    if top and top < v.shape[0]:
        idx = np.argsort(np.abs(v).sum(axis=1))[-top:]
        v = v[idx]
    return decode_message(v.sum(axis=0), k, n_slots=v.shape[1])


def _best_lane(
    lane_values: np.ndarray,
    code: EccCode,
    identity_idx: int | None = None,
    identity_margin: float = 1.0,
) -> tuple[int, EccResult]:
    """Pick the compensation lane whose ML decode is most significant.

    ``lane_values``: (H, n) raw detector values, one row per hypothesis.
    Lanes are scored by the normalized max codebook correlation (the
    z-statistic behind the presence p-value) — the codebook constraint
    makes a wrong lane's best correlation concentrate near the null,
    a sharper selector than mean |values| for message mode.  As in
    robust._search, ``identity_margin > 1`` keeps the identity lane
    unless another beats it by that factor.
    """
    v = np.asarray(lane_values, dtype=np.float32)
    results = [code.decode(v[h]) for h in range(v.shape[0])]
    z = np.array([
        r.score / ((float(np.std(v[h])) or 1e-12) * math.sqrt(code.n))
        for h, r in enumerate(results)
    ])
    best = int(np.argmax(z))
    if (
        identity_idx is not None
        and identity_margin > 1.0
        and z[best] < identity_margin * z[identity_idx]
    ):
        best = identity_idx
    return best, results[best]


def detect_message_robust(
    audio,
    sample_rate,
    detector,
    k: int,
    rates: tuple[float, ...] | None = None,
    stretch_rates: tuple[float, ...] | None = None,
    identity_margin: float = 1.0,
):
    """ML message decode under unknown time scaling.

    Runs the robust compensation grid (``service/robust.py``: resample
    and vocoder-stretch lanes in one masked forward), ML-decodes every
    lane, and returns ``(EccResult, kind, rate)`` for the lane whose
    decode is most significant (``_best_lane``).  The default
    ``identity_margin`` of 1.0 is the pure argmax, for solver-strength
    marks; the JAX package's records advise 1.9 for weak marks, on which a
    spurious lane can otherwise win.
    """
    from aware_tpu_torch.service import robust as _robust

    a = np.asarray(audio, dtype=np.float32)
    if a.ndim == 2:
        a = a.mean(axis=1)
    if sample_rate != detector.cfg.detection_net.sample_rate:
        raise ValueError(
            f"Robust detector operates at "
            f"{detector.cfg.detection_net.sample_rate} Hz"
        )
    rates = _robust.DEFAULT_RATES if rates is None else tuple(rates)
    stretch_rates = (
        _robust.DEFAULT_STRETCH_RATES if stretch_rates is None
        else tuple(stretch_rates)
    )
    values = _robust.robust_values(detector, a, rates, stretch_rates)
    code = get_code(k, values.shape[1])
    ident = rates.index(1.0) if 1.0 in rates else None
    best, result = _best_lane(values, code, ident, identity_margin)
    hyps = [("resample", r) for r in rates] + [
        ("stretch", r) for r in stretch_rates
    ]
    kind, rate = hyps[best]
    return result, kind, rate


def detect_message(audio, sample_rate, detector, k: int) -> EccResult:
    """Detect + ML-decode a k-bit message from one clip.

    Stereo handling mirrors detect_watermark's per-bit abs-max merge
    (reference: src/AWARE/service/detect.py:30-43) on the raw values
    before decoding.
    """
    a = np.asarray(audio, dtype=np.float32)
    if a.ndim == 2:
        vals = np.stack(
            [detector.detect(a[:, c], sample_rate) for c in range(a.shape[1])]
        )
        pick = np.abs(vals).argmax(axis=0)
        values = vals[pick, np.arange(vals.shape[1])]
    else:
        values = detector.detect(a, sample_rate)
    return decode_message(values, k, n_slots=int(values.size))
