"""Typed configuration of the port.

The fields this slice reads, with the default card's values written in
Python (``aware_tpu/config.py`` holds the same defaults).  No YAML is read
here; ``service.api.load`` parses a card file given by path, lazily.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class DetectorNetConfig:
    """Architecture of the keyed detector CNN (the default card's)."""

    sample_rate: int = 16000
    n_fft: int = 1024
    n_mels: int = 128
    num_blocks: int = 3
    initial_pool_size: int = 2
    initial_pool_stride: int = 2
    n_filters: tuple[int, ...] = (512, 1024, 1024)
    output_length: int = 20
    # the key bundle: a file name under the JAX package's models/_key, or an
    # absolute path; empty selects the default key (aware_key_v1.npz).
    # Re-keyed cards (the desync card) name theirs here
    key_file: str = ""

    def __post_init__(self) -> None:
        if len(self.n_filters) != self.num_blocks:
            raise ValueError("Number of filters must match number of blocks")

    @property
    def channels(self) -> tuple[int, ...]:
        """Channel sizes of the num_blocks+1 conv blocks, input first."""
        return (self.n_mels, *self.n_filters, 2 * self.output_length)


# the matmul precisions (the JAX package's names): "highest" selects the
# float32 slab round trip, "high" and "default" the kernels.  Outside the
# kernels (which are bf16 on every precision) "high" and "highest" multiply
# in float32, and "default" (the turbo card's) as jax.lax.Precision.DEFAULT
# does on a TPU: one bf16 pass, operands rounded to bf16, float32
# accumulation and result (models/detector.py matmul)
MATMUL_PRECISIONS = ("high", "highest", "default")

# the EOT views' settings, each a tuple of view parameters
EOT_FIELDS = ("eot_stretch_rates", "eot_pitch_cents", "eot_mp3_qualities",
              "eot_celp_modes", "eot_ste_codecs")


@dataclasses.dataclass(frozen=True)
class AwareConfig:
    """Framework configuration: the default card's values."""

    frame_length: int = 1024
    hop_length: int = 256
    window: str = "hann"
    win_length: int = 1024
    pattern_mode: str = "bits2bipolar"
    watermark_length: int = 20
    embedding_bands: tuple[float, float] = (500.0, 4000.0)
    tolerance_db: float = 6.0
    num_iterations: int = 400
    optimizer_name: str = "nadam"
    # sorted (key, value) tuples keep the config hashable; read them
    # through .opt_params / .sched_params
    optimizer_params: Any = (("lr", 0.1),)
    scheduler_name: str = "reduce_lr_on_plateau"
    scheduler_params: Any = (("factor", 0.9), ("patience", 500))
    loss: str = "push_extremes"
    vad: str = "spectral"
    detection_net: DetectorNetConfig = dataclasses.field(
        default_factory=DetectorNetConfig
    )
    threshold: float = 0.0
    # the solver paths of the JAX package this port mirrors
    # (embed/solver.py selects them as its gate does), with the JAX
    # package's defaults except use_pallas_roundtrip, which is on here as
    # it is on a TPU.  use_matmul_dft=False: the FFT round trip;
    # use_pallas_ola: the frames round trip through the ola_normalize
    # kernel; use_slab_dft=False: the frames round trip in plain float32;
    # use_pallas_roundtrip=False or matmul_precision "highest": the slab
    # round trip in plain float32.  Otherwise the kernels: with
    # use_pallas_iteration and use_pallas_detector, where the fused
    # detector's gate holds, the whole-iteration kernels (iteration_step
    # for push_extremes + NAdam without weight decay, else
    # iteration_forward and its VJP); with use_pallas_iteration=False
    # synth_norm -> the merged analysis_detector kernels; with
    # use_pallas_detector=False synth_norm -> band_analysis -> edge
    # corrections -> the detector in plain torch
    matmul_precision: str = "high"
    # the JAX package's lax.scan unroll factor of its solver loop; validated
    # as a positive int and otherwise unread: the port's loop is a Python
    # loop, with no scan to unroll
    scan_unroll: int = 1
    use_matmul_dft: bool = True
    use_slab_dft: bool = True
    use_pallas_ola: bool = False
    use_pallas_roundtrip: bool = True
    use_pallas_detector: bool = True
    use_pallas_iteration: bool = True
    # EOT (expectation over transforms) views: each iteration also scores
    # the candidate waveform after a differentiable edit and adds
    # eot_weight x that loss (embed/solver.py).  Vocoder time-stretch
    # rates, pitch shifts in cents, mp3_approx qualities 0-11, celp_approx
    # modes ("nb8k", "mb16k"), and real host codecs with a straight-through
    # gradient ("opus_8k", "opus_16k", "gsm_fr"; not ported).  "all" takes
    # the mean over the views every iteration, "cycle" view it % n_views
    eot_stretch_rates: Any = ()
    eot_pitch_cents: Any = ()
    eot_mp3_qualities: Any = ()
    eot_celp_modes: Any = ()
    eot_ste_codecs: Any = ()
    eot_weight: float = 1.0
    eot_mode: str = "all"

    def __post_init__(self) -> None:
        if self.window not in ("hann", "hamming"):
            raise ValueError(f"Invalid window type: {self.window}")
        if self.eot_mode not in ("all", "cycle"):
            raise ValueError(f"Invalid eot_mode: {self.eot_mode}")
        if (isinstance(self.scan_unroll, bool) or not isinstance(self.scan_unroll, int)
                or self.scan_unroll < 1):
            raise ValueError(f"scan_unroll must be a positive int, got {self.scan_unroll!r}")
        for field in ("optimizer_params", "scheduler_params", "embedding_bands", *EOT_FIELDS):
            value = getattr(self, field)
            if isinstance(value, Mapping):
                value = tuple(sorted(value.items()))
            elif isinstance(value, list):
                value = tuple(value)
            object.__setattr__(self, field, value)
        bad_q = [q for q in self.eot_mp3_qualities if int(q) not in range(12)]
        if bad_q:
            raise ValueError(f"Invalid eot_mp3_qualities (0-11): {bad_q}")
        bad_m = [m for m in self.eot_celp_modes if m not in ("nb8k", "mb16k")]
        if bad_m:
            raise ValueError(f"Invalid eot_celp_modes: {bad_m}")
        bad_s = [s for s in self.eot_ste_codecs if s not in ("opus_8k", "opus_16k", "gsm_fr")]
        if bad_s:
            raise ValueError(f"Invalid eot_ste_codecs: {bad_s}")

    @property
    def opt_params(self) -> dict[str, Any]:
        return dict(self.optimizer_params)

    @property
    def sched_params(self) -> dict[str, Any]:
        return dict(self.scheduler_params)

    @classmethod
    def from_dict(cls, card: Mapping[str, Any]) -> "AwareConfig":
        """Config from a card's mapping (the JAX package's key names).

        Keys this port does not read raise, all of them named in one
        error, so that a card never selects an unported path silently.
        """
        simple = {
            "frame_length", "hop_length", "window", "win_length",
            "pattern_mode", "watermark_length", "tolerance_db",
            "num_iterations", "loss", "threshold", "vad",
            "use_pallas_roundtrip", "use_pallas_detector", "use_pallas_iteration",
            "use_matmul_dft", "use_slab_dft", "use_pallas_ola",
            "eot_weight", "eot_mode", "scan_unroll",
        }
        # read by the JAX package only; their default values change
        # nothing here
        inert = {"verbose": False, "dtype": "float32"}
        kwargs: dict[str, Any] = {}
        unread = []
        for key, value in card.items():
            if key in simple:
                kwargs[key] = value
            elif key == "matmul_precision" and value in MATMUL_PRECISIONS:
                kwargs[key] = value
            elif key == "embedding_bands" or key in EOT_FIELDS:
                kwargs[key] = tuple(value)
            elif key == "optimizer_cfg":
                kwargs["optimizer_name"] = value.get("name", "nadam")
                kwargs["optimizer_params"] = dict(value.get("params", {"lr": 0.1}))
            elif key == "scheduler_cfg":
                kwargs["scheduler_name"] = value.get(
                    "name", "reduce_lr_on_plateau"
                )
                kwargs["scheduler_params"] = dict(value.get("params", {}))
            elif key == "detection_net_cfg":
                net = dict(value)
                for k in ("activation", "final_activation", "norm_layer"):
                    default = {"activation": "leaky_relu",
                               "final_activation": "tanh",
                               "norm_layer": "instance"}[k]
                    if net.pop(k, default) != default:
                        raise NotImplementedError(
                            f"detection_net_cfg.{k} other than {default!r} "
                            "is not ported"
                        )
                if "n_filters" in net:
                    net["n_filters"] = tuple(net["n_filters"])
                kwargs["detection_net"] = DetectorNetConfig(**net)
            elif key in inert and value == inert[key]:
                continue
            else:
                unread.append(f"{key!r} = {value!r}")
        if unread:
            raise NotImplementedError(
                f"card keys {', '.join(unread)} select paths this port does not have"
            )
        return cls(**kwargs)

    def replace(self, **kwargs: Any) -> "AwareConfig":
        return dataclasses.replace(self, **kwargs)


def in_band_bins(
    sample_rate: int, n_fft: int, bands: Sequence[float]
) -> tuple[int, int]:
    """Half-open bin range [lo, hi) of the FFT bins inside the band.

    The frequency grid is a linspace, so the selected bins are always one
    contiguous run.
    """
    freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mask = (freqs >= bands[0]) & (freqs <= bands[1])
    idx = np.where(mask)[0]
    if len(idx) == 0:
        raise ValueError(f"No FFT bins inside embedding band {bands}")
    if not np.array_equal(idx, np.arange(idx[0], idx[-1] + 1)):
        raise AssertionError("embedding band bins are not contiguous")
    return int(idx[0]), int(idx[-1] + 1)
