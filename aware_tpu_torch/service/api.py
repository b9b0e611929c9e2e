"""Public service API: load / embed_watermark / detect_watermark.

The port of ``aware_tpu/service/api.py``, numpy in and numpy out.  The
handles hold the keyed detector on one device: the CUDA card unless
``load(device="cpu")`` asks for the CPU.  Nothing falls back to the CPU
quietly.

Reference quirks kept: the per-channel rescale uses the **signed max** of
the pre-embed channel, not the absolute max; stereo detection merges per
bit by the larger absolute value; silent clips are rejected by the VAD
gate that ``cfg.vad`` names (or, in a batch with ``on_silent="mask"``,
passed through): "spectral" on the device, "webrtc_gmm" the host
runtime's GMM classifier (``native.py``), clip by clip.
Sample rates other than the model's 16 kHz are resampled in and back out.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Any

import numpy as np
import torch

from aware_tpu_torch.config import AwareConfig
from aware_tpu_torch.device import float32_products, resolve_device
from aware_tpu_torch.embed.losses import get_loss_fn
from aware_tpu_torch.embed.optim import get_optimizer
from aware_tpu_torch.embed.schedulers import get_scheduler
from aware_tpu_torch.embed.solver import check_supported, embed_batch, embed_lbfgs
from aware_tpu_torch.models.detector import (
    DetectorNet,
    detect_values_batch,
    init_params,
    params_from_jax,
)
from aware_tpu_torch.ops.resample import resample
from aware_tpu_torch.ops.vad import is_silent
from aware_tpu_torch.service.codec import decode_pattern, encode_pattern

_SILENT = (
    "Signal you provided doesn't contain any speech. "
    "Please provide signal that contains speech."
)


# the JAX package's cards, read as data by bare name
CARDS_DIR = pathlib.Path(__file__).resolve().parents[2] / "aware_tpu" / "cards"


def _card_path(card: str | pathlib.Path) -> pathlib.Path:
    """A card given by path, or by the bare name of one in CARDS_DIR (as
    ``aware_tpu/service/api.py:167-174`` resolves it)."""
    path = pathlib.Path(card)
    if not path.exists() and (CARDS_DIR / f"{card}.yaml").exists():
        return CARDS_DIR / f"{card}.yaml"
    return path


@dataclasses.dataclass(frozen=True, eq=False)
class AWAREEmbedder:
    """Embedder handle: the frozen keyed detector + config, on a device."""

    net: DetectorNet
    cfg: AwareConfig
    device: torch.device

    @property
    def pattern_mode(self) -> str:
        return self.cfg.pattern_mode

    @property
    def output_length(self) -> int:
        return self.cfg.detection_net.output_length

    def embed_batch(self, audios: np.ndarray, patterns: np.ndarray) -> np.ndarray:
        """Bipolar patterns (B, n_bits) into mono clips (B, L) at the model
        rate; returns the peak-normalized watermarked waveforms."""
        res = embed_batch(
            self.net,
            torch.as_tensor(np.asarray(audios, np.float32), device=self.device),
            torch.as_tensor(np.asarray(patterns, np.float32), device=self.device),
            self.cfg,
        )
        return res.audio.cpu().numpy()

    def embed(self, audio: np.ndarray, sample_rate: int, watermark: np.ndarray) -> np.ndarray:
        """One mono clip at the model rate (see :meth:`embed_batch`);
        ``lbfgs`` takes its host loop, ``embed_lbfgs``."""
        if sample_rate != self.cfg.detection_net.sample_rate:
            raise ValueError(
                f"Embedder operates at {self.cfg.detection_net.sample_rate} Hz"
            )
        if self.cfg.optimizer_name == "lbfgs":
            res = embed_lbfgs(
                self.net,
                torch.as_tensor(np.asarray(audio, np.float32), device=self.device),
                torch.as_tensor(np.asarray(watermark, np.float32), device=self.device),
                self.cfg,
            )
            return res.audio.cpu().numpy()
        return self.embed_batch(np.asarray(audio)[None], np.asarray(watermark)[None])[0]


@dataclasses.dataclass(frozen=True, eq=False)
class AWAREDetector:
    """Detector handle sharing the embedder's keyed net."""

    net: DetectorNet
    cfg: AwareConfig
    device: torch.device

    @property
    def threshold(self) -> float:
        return self.cfg.threshold

    @property
    def pattern_mode(self) -> str:
        return self.cfg.pattern_mode

    def detect_batch(self, audios: np.ndarray) -> np.ndarray:
        """Mono clips (B, L) at the model rate -> raw values (B, n_bits)."""
        values = detect_values_batch(
            self.net,
            torch.as_tensor(np.asarray(audios, np.float32), device=self.device),
            hop_length=self.cfg.hop_length,
            window=self.cfg.window,
            win_length=self.cfg.win_length,
            embedding_bands=self.cfg.embedding_bands,
            precision=self.cfg.matmul_precision,
        )
        return values.cpu().numpy()

    def detect(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        """One mono clip -> raw detector values."""
        if sample_rate != self.cfg.detection_net.sample_rate:
            raise ValueError(
                f"Detector operates at {self.cfg.detection_net.sample_rate} Hz"
            )
        return self.detect_batch(np.asarray(audio)[None])[0]


def load(
    card: str | pathlib.Path | None = None,
    device: str | torch.device | None = None,
    **overrides: Any,
) -> tuple[AWAREEmbedder, AWAREDetector]:
    """Build the (embedder, detector) pair sharing one keyed net.

    ``card`` is a YAML card file given by path (the JAX package's key
    names), or the bare name of one of the JAX package's cards
    (``aware_tpu/cards/<name>.yaml``, read as data); with none, the
    default card's values.  ``device`` defaults to the CUDA card and raises
    where there is none.  A card or keyword that asks for a path this port
    does not have raises NotImplementedError.  The detector is the card's
    ``detection_net_cfg`` (any architecture of the JAX package's schema);
    its weights are those ``models.detector.init_params`` chooses: the
    bundle its ``key_file`` names (the desync card's re-keyed bundle), the
    golden key for the default architecture, or the JAX package's fresh
    init of any other, bit for bit.  Another architecture than the default
    card's (another norm, activation or width) stays off the detector
    kernels, as the JAX gate keeps it off them, and its solver runs the
    detector in plain torch.

    The embed solver takes the JAX package's paths, selected as there
    (``embed/solver.py`` names them).  By default, the kernel paths (bf16
    operands, float32 accumulation, as the TPU kernels): the whole step is
    one ``iteration_step`` kernel chain per iteration; with weight decay
    the ``iteration_forward`` kernels and their VJP;
    ``use_pallas_iteration=False`` takes the round-trip synthesis kernel
    and then the merged analysis + fused detector kernels;
    ``use_pallas_detector=False`` the synthesis and analysis kernels and
    the float32 plain-torch detector; clips over 1024 frames the
    time-tiled kernels.  The float32 round trips: the JAX package's
    default card file (``load("config")``, ``matmul_precision: highest``)
    or ``use_pallas_roundtrip=False`` the "slab" path;
    ``use_slab_dft=False`` the "frames" path; ``use_pallas_ola=True`` the
    "ola" path (the frames round trip through the ``ola_normalize``
    kernel); ``use_matmul_dft=False`` the "fft" path.  Cards with EOT views
    (``load("robust")``, ``"desync"``, ``"compression"``, ``"voice"``)
    never take the whole-iteration kernels, as in the JAX package: by
    default they run the synthesis kernel, the merged analysis + detector
    kernels and the views in plain torch; the voice card's views run the
    real codecs (libopus, libgsm) on the host, lane by lane, with a
    straight-through gradient, and ``load`` raises RuntimeError naming a
    codec library that does not load here.  Every loss, optimizer and scheduler of the card
    schema loads (``loss``, ``optimizer_cfg``, ``scheduler_cfg``, or the
    keywords ``loss=``, ``optimizer_name=`` / ``optimizer_params=``,
    ``scheduler_name=`` / ``scheduler_params=``): a loss or optimizer other
    than push_extremes + NAdam without weight decay takes the
    ``iteration_forward`` kernels (the JAX gate's), a scheduler alone
    stays on the whole-step kernel; ``lbfgs`` embeds one clip at a time
    (``embed_watermark``; the batch call raises ValueError, as in the JAX
    package).  ``vad="webrtc_gmm"`` gates silence with the host runtime's
    GMM classifier.  ``load("turbo")`` (50 iterations, ``matmul_precision:
    default``) takes the kernel paths, and its plain products (set-up,
    detector) one bf16 pass each, as ``jax.lax.Precision.DEFAULT`` on a
    TPU; its ``scan_unroll`` is read and unused.  Detection is the
    plain-torch detector at the card's precision, as in the JAX package,
    which has no detection kernel.

    TF32 is turned off for float32 matmuls and convolutions (process-wide
    switches of torch): the float32 detector would not match the JAX
    package's with it.
    """
    dev = resolve_device(device)
    if card is not None:
        import yaml  # only for a card file; the default path needs none

        cfg = AwareConfig.from_dict(yaml.safe_load(_card_path(card).read_text()) or {})
    else:
        cfg = AwareConfig()
    if overrides:
        cfg = cfg.replace(**overrides)
    check_supported(cfg)
    # an unknown name or parameter raises here, not at the first embed
    get_loss_fn(cfg.loss)
    get_optimizer(cfg.optimizer_name, **cfg.opt_params)
    get_scheduler(cfg.scheduler_name, **cfg.sched_params)
    float32_products()
    net_cfg = cfg.detection_net
    net = DetectorNet(params_from_jax(init_params(net_cfg)), net_cfg).to(dev)
    return (
        AWAREEmbedder(net=net, cfg=cfg, device=dev),
        AWAREDetector(net=net, cfg=cfg, device=dev),
    )


# ---------------------------------------------------------------------------
# Service functions
# ---------------------------------------------------------------------------

def _silent(audios: np.ndarray, sample_rate: int, model: AWAREEmbedder) -> np.ndarray:
    """The silence gate that ``cfg.vad`` names, per clip of (..., L) host
    audio -> bool array (...): "spectral" on the model's device,
    "webrtc_gmm" the host runtime's GMM classifier clip by clip (as the
    JAX package's ``_gate_silent``; it raises without the library)."""
    audios = np.asarray(audios, np.float32)
    if model.cfg.vad == "webrtc_gmm":
        from aware_tpu_torch.native import vad_gmm_is_silent

        flat = audios.reshape(-1, audios.shape[-1])
        return np.array([vad_gmm_is_silent(a, sample_rate) for a in flat]).reshape(
            audios.shape[:-1])
    x = torch.as_tensor(audios, device=model.device)
    return is_silent(x, sample_rate).cpu().numpy()


def _as_float_mono(audio: np.ndarray) -> np.ndarray:
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 2 and audio.shape[1] == 1:
        audio = audio[:, 0]
    return audio


def _validate_pattern(watermark, model: AWAREEmbedder) -> np.ndarray:
    if len(watermark) != model.output_length:
        raise ValueError(
            f"Invalid watermark length. Expected {model.output_length}, "
            f"got {len(watermark)}."
        )
    return np.asarray(watermark, dtype=np.float32)


def _resample_nd(audio: np.ndarray, orig_sr: int, target_sr: int,
                 device: torch.device) -> np.ndarray:
    """Resample host audio (..., L) along its last axis."""
    x = torch.as_tensor(np.asarray(audio, np.float32), device=device)
    return resample(x, orig_sr, target_sr).cpu().numpy()


def _resample_columns(audio: np.ndarray, orig_sr: int, target_sr: int,
                      device: torch.device) -> np.ndarray:
    """Resample mono (L,) or multi-channel (L, C) host audio."""
    if audio.ndim == 1:
        return _resample_nd(audio, orig_sr, target_sr, device)
    return _resample_nd(audio.T, orig_sr, target_sr, device).T.copy()


def embed_watermark(
    audio: np.ndarray,
    sample_rate: int,
    watermark_bits: bytes | np.ndarray,
    model: AWAREEmbedder,
) -> np.ndarray:
    """Embed ``watermark_bits`` into ``audio``; returns watermarked audio."""
    pattern = _validate_pattern(encode_pattern(watermark_bits, model.pattern_mode), model)
    audio = np.asarray(audio, dtype=np.float32)

    model_sr = model.cfg.detection_net.sample_rate
    if sample_rate != model_sr:
        work = _resample_columns(audio, sample_rate, model_sr, model.device)
        out = embed_watermark(work, model_sr, watermark_bits, model)
        return _resample_columns(out, model_sr, sample_rate, model.device)

    if audio.ndim == 2 and audio.shape[1] == 2:  # stereo
        left, right = audio[:, 0], audio[:, 1]
        left_mx, right_mx = np.max(left), np.max(right)  # signed-max quirk
        silent_l, silent_r = _silent(audio.T, sample_rate, model)
        if silent_l and silent_r:
            raise ValueError(_SILENT)
        left_wm = model.embed(left, sample_rate, pattern) * left_mx
        right_wm = model.embed(right, sample_rate, pattern) * right_mx
        return np.column_stack((left_wm, right_wm))

    if audio.ndim == 1 or (audio.ndim == 2 and audio.shape[1] == 1):  # mono
        mono = _as_float_mono(audio)
        if _silent(mono, sample_rate, model):
            raise ValueError(_SILENT)
        audio_mx = np.max(mono)  # signed-max quirk
        return model.embed(mono, sample_rate, pattern) * audio_mx

    raise ValueError("Invalid audio shape. Expected 1D or 2D numpy array.")


def detect_watermark(audio: np.ndarray, sample_rate: int, detector: AWAREDetector):
    """Detect and decode the embedded pattern."""
    audio = np.asarray(audio, dtype=np.float32)
    model_sr = detector.cfg.detection_net.sample_rate
    if sample_rate != model_sr:
        audio = _resample_columns(audio, sample_rate, model_sr, detector.device)
        sample_rate = model_sr

    if audio.ndim == 2 and audio.shape[1] == 2:  # stereo
        left, right = detector.detect_batch(audio.T)
        values = np.where(np.abs(left) > np.abs(right), left, right)
    elif audio.ndim == 1 or (audio.ndim == 2 and audio.shape[1] == 1):
        values = detector.detect(_as_float_mono(audio), sample_rate)
    else:
        raise ValueError("Invalid audio shape. Expected 1D or 2D numpy array.")
    return decode_pattern(values, detector.pattern_mode, detector.threshold)


def embed_watermark_batch(
    audios: np.ndarray,
    sample_rate: int,
    watermark_bits: np.ndarray,
    model: AWAREEmbedder,
    check_silence: bool = True,
    on_silent: str = "raise",
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """Embed B patterns into B equal-length mono clips in one solve.
    audios: (B, L); watermark_bits: (B, n_bits).

    Returns (B, (T-1)*hop) watermarked clips, rescaled per the service
    contract.  ``on_silent="raise"``: any silent clip raises;
    ``on_silent="mask"``: silent lanes pass through unwatermarked and the
    call returns ``(out, embedded_mask)``.
    """
    audios = np.asarray(audios, dtype=np.float32)
    if audios.ndim != 2:
        raise ValueError("embed_watermark_batch expects (B, L) mono clips")
    if on_silent not in ("raise", "mask"):
        raise ValueError("on_silent must be 'raise' or 'mask'")
    patterns = np.stack(
        [
            _validate_pattern(encode_pattern(w, model.pattern_mode), model)
            for w in np.asarray(watermark_bits)
        ]
    )
    model_sr = model.cfg.detection_net.sample_rate
    if sample_rate != model_sr:
        audios = _resample_nd(audios, sample_rate, model_sr, model.device)
    silent = np.zeros(audios.shape[0], bool)
    if check_silence:
        silent = _silent(audios, model_sr, model)
        if silent.any() and on_silent == "raise":
            raise ValueError(f"Clips {np.where(silent)[0].tolist()} contain no speech.")
    mx = np.max(audios, axis=1)  # signed-max quirk, per clip
    out = model.embed_batch(audios, patterns) * mx[:, None]
    if silent.any():
        out[silent] = audios[silent, : out.shape[1]]
    if sample_rate != model_sr:
        out = _resample_nd(out, model_sr, sample_rate, model.device)
    if on_silent == "mask":
        return out, ~silent
    return out


def detect_watermark_batch(
    audios: np.ndarray, sample_rate: int, detector: AWAREDetector
) -> np.ndarray:
    """Detect over (B, L) mono clips; returns (B, n_bits) decoded bits."""
    audios = np.asarray(audios, dtype=np.float32)
    model_sr = detector.cfg.detection_net.sample_rate
    if sample_rate != model_sr:
        audios = _resample_nd(audios, sample_rate, model_sr, detector.device)
    values = detector.detect_batch(audios)
    return np.stack(
        [decode_pattern(v, detector.pattern_mode, detector.threshold) for v in values]
    )
