"""Fast embedding modes: the one-shot amortized embed and the warm-started
solver embed.

The port of ``aware_tpu/service/fast.py``:

* ``embed_watermark_oneshot``: one forward pass of a bundled amortized
  embedder (``train/adversarial.py`` ``embedder_apply``), plain torch on
  the model's device; no optimization loop and no kernel;
* ``embed_watermark_turbo``: the solver embed warm-started from the
  amortized prediction with a reduced iteration budget (``num_iterations``,
  100 by default), on the path ``load()`` gives the model: on the default
  card the whole-step kernel (``iteration_step``) once an iteration.

The bundles are the JAX package's numpy files under its ``models/_key``,
read by path as data.  A variant's trained box width, where it has one,
applies unless the caller overrides ``tolerance_db``.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

from aware_tpu_torch.config import in_band_bins
from aware_tpu_torch.embed.solver import embed_batch
from aware_tpu_torch.models.detector import KEY_DIR
from aware_tpu_torch.ops.stft import istft, magphase, peak_normalize, polar, stft
from aware_tpu_torch.ops.windows import get_window
from aware_tpu_torch.service.api import AWAREEmbedder, _validate_pattern
from aware_tpu_torch.service.codec import encode_pattern
from aware_tpu_torch.train.adversarial import embedder_apply

_AMORTIZED_PATH = KEY_DIR / "amortized_v1.npz"

# the bundles and their trained box widths (None: the card's tolerance_db),
# as the JAX package's (aware_tpu/service/fast.py:62-88)
_VARIANTS: dict[str, tuple[pathlib.Path, float | None]] = {
    "default": (KEY_DIR / "amortized_v2_diverse_tol2_seg4.npz", 2.0),
    "speech_v1": (_AMORTIZED_PATH, None),
    "diverse": (KEY_DIR / "amortized_v1_diverse.npz", None),
    "diverse_tol2": (KEY_DIR / "amortized_v2_diverse_tol2_seg4.npz", 2.0),
    "diverse_tol2_eot": (KEY_DIR / "amortized_v2_diverse_tol2_seg5eot.npz", 2.0),
}


@functools.lru_cache(maxsize=8)
def _load_amortized(variant: str, device: torch.device) -> dict[str, torch.Tensor]:
    path, _ = _VARIANTS.get(variant, (None, None))
    if path is None or not path.exists():
        raise FileNotFoundError(f"amortized bundle {variant!r} missing; the variants are "
                                f"{sorted(_VARIANTS)}")
    with np.load(path) as z:
        return {k: torch.as_tensor(z[k], dtype=torch.float32, device=device) for k in z.files}


def _amortized_band(model: AWAREEmbedder, audio: np.ndarray, pattern: np.ndarray,
                    variant: str = "default", tolerance_db: float | None = None):
    """The bundle's in-band prediction (n_band, T) for one clip, with the
    clip's magnitude and phase (F, T), the band's bins and the window."""
    cfg = model.cfg
    window = get_window(cfg.window, cfg.win_length)
    lo, hi = in_band_bins(cfg.detection_net.sample_rate, cfg.frame_length, cfg.embedding_bands)
    x = torch.as_tensor(np.asarray(audio, np.float32), device=model.device)
    mag, phase = magphase(stft(peak_normalize(x), cfg.frame_length, cfg.hop_length, window))
    # resolution order: an explicit override, then the variant's trained
    # box width, then the card's tolerance_db
    if tolerance_db is None:
        tolerance_db = _VARIANTS.get(variant, (None, None))[1]
    tol = cfg.tolerance_db if tolerance_db is None else float(tolerance_db)
    pat = torch.as_tensor(np.asarray(pattern, np.float32), device=model.device)
    band = embedder_apply(_load_amortized(variant, model.device), mag[None, lo:hi], pat[None],
                          tol, band_phase=phase[None, lo:hi])[0]
    return band, mag, phase, lo, hi, window


def embed_watermark_oneshot(
    audio: np.ndarray,
    sample_rate: int,
    watermark_bits,
    model: AWAREEmbedder,
    variant: str = "default",
    tolerance_db: float | None = None,
) -> np.ndarray:
    """One-forward-pass embed of a mono clip at the model rate (16 kHz):
    the amortized network's band, written into the clip's magnitude, the
    ISTFT, the peak-norm, and the service's signed-max rescale.
    ``tolerance_db`` overrides the box for this embed alone."""
    pattern = _validate_pattern(encode_pattern(watermark_bits, model.pattern_mode), model)
    cfg = model.cfg
    if sample_rate != cfg.detection_net.sample_rate:
        raise ValueError("one-shot embed operates at the model rate (16 kHz)")
    mono = np.asarray(audio, np.float32)
    mx = np.max(mono)
    with torch.no_grad():
        band, mag, phase, lo, hi, window = _amortized_band(model, mono, pattern, variant,
                                                           tolerance_db)
        wmag = torch.cat([mag[:lo], band, mag[hi:]], dim=0)
        out = peak_normalize(istft(polar(wmag, phase), cfg.frame_length, cfg.hop_length,
                                   window))
    return out.cpu().numpy() * mx


def embed_watermark_turbo(
    audio: np.ndarray,
    sample_rate: int,
    watermark_bits,
    model: AWAREEmbedder,
    num_iterations: int = 100,
    variant: str = "default",
) -> np.ndarray:
    """The solver embed of a mono clip at the model rate, warm-started from
    the amortized prediction (clipped into the card's box), for
    ``num_iterations`` iterations on the model's path; the service's
    contract otherwise."""
    pattern = _validate_pattern(encode_pattern(watermark_bits, model.pattern_mode), model)
    cfg = model.cfg
    if sample_rate != cfg.detection_net.sample_rate:
        raise ValueError("turbo embed operates at the model rate (16 kHz)")
    mono = np.asarray(audio, np.float32)
    mx = np.max(mono)
    with torch.no_grad():
        band, *_ = _amortized_band(model, mono, pattern, variant)
    x = torch.as_tensor(mono, device=model.device)
    w = torch.as_tensor(pattern, device=model.device)
    res = embed_batch(model.net, x[None], w[None], cfg.replace(num_iterations=num_iterations),
                      init_coeffs=band[None])
    return res.audio[0].cpu().numpy() * mx
