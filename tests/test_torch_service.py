"""The port's service pieces against the JAX package: resampling, the
spectral VAD gate, the pattern codec and the config defaults.

Resampling agrees to 1e-5 * max|ref| (one float32 matmul each, summed in
different orders); the VAD's decisions, the codec's outputs and the
config values must be equal.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aware_tpu.config import AwareConfig as JaxConfig
from aware_tpu.config import in_band_bins as jax_in_band_bins
from aware_tpu.service import codec as jcodec
from aware_tpu_torch.config import AwareConfig, in_band_bins
from aware_tpu_torch.ops import resample as tres
from aware_tpu_torch.ops import vad as tvad
from aware_tpu_torch.service import codec as tcodec

jres = importlib.import_module("aware_tpu.ops.resample")
jvad = importlib.import_module("aware_tpu.ops.vad")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("orig,target", [(44100, 16000), (16000, 44100), (48000, 16000),
                                         (22050, 16000), (16000, 16000)])
def test_resample_matches_jax(orig, target):
    x = np.random.default_rng(orig).standard_normal((2, 3001)).astype(np.float32)
    ours = tres.resample(torch.from_numpy(x), orig, target).numpy()
    ref = np.asarray(jres.resample(jnp.asarray(x), orig, target))
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) <= 1e-5 * np.max(np.abs(ref))


def test_polyphase_filter_equals_jax():
    np.testing.assert_array_equal(tres.polyphase_filter(160, 441),
                                  jres.polyphase_filter(160, 441))


def _vad_clips(speechlike):
    rng = np.random.default_rng(4)
    t = np.arange(len(speechlike)) / 16000
    return np.stack([
        speechlike,
        np.zeros_like(speechlike),
        (0.5 * rng.standard_normal(len(speechlike))).astype(np.float32),   # white noise
        (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32),             # a pure tone
        (1e-4 * speechlike).astype(np.float32),                             # too quiet
    ])


def test_vad_decisions_match_jax(speechlike):
    clips = _vad_clips(speechlike)
    ours = tvad.is_silent(torch.from_numpy(clips)).numpy()
    ref = np.asarray(jvad.is_silent(clips))
    np.testing.assert_array_equal(ours, ref)
    assert not ours[0] and ours[1] and ours[2]


def test_vad_frame_flags_match_jax(speechlike):
    clips = _vad_clips(speechlike)
    ours = tvad.frame_voiced_flags(torch.from_numpy(clips)).numpy()
    ref = np.asarray(jvad.frame_voiced_flags(jnp.asarray(clips)))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("mode", ["bits2bipolar", "bytes2bipolar", "bytes2bits", "bits"])
def test_codec_matches_jax(mode):
    payload = b"\x5a\x0f\xf0" if mode.startswith("bytes") else np.array([1, 0, 1, 1, 0])
    np.testing.assert_array_equal(tcodec.encode_pattern(payload, mode),
                                  jcodec.encode_pattern(payload, mode))
    values = np.random.default_rng(1).standard_normal(24)
    ours = tcodec.decode_pattern(values, mode, 0.1)
    ref = jcodec.decode_pattern(values, mode, 0.1)
    if isinstance(ref, bytes):
        assert ours == ref
    else:
        np.testing.assert_array_equal(ours, ref)


def test_config_defaults_equal_the_jax_package():
    ours, ref = AwareConfig(), JaxConfig()
    for field in ("frame_length", "hop_length", "window", "win_length", "pattern_mode",
                  "watermark_length", "embedding_bands", "tolerance_db", "num_iterations",
                  "optimizer_name", "opt_params", "scheduler_name", "sched_params", "loss",
                  "vad", "threshold", "use_pallas_detector", "use_pallas_iteration",
                  "matmul_precision", "use_matmul_dft", "use_slab_dft", "use_pallas_ola"):
        assert getattr(ours, field) == getattr(ref, field), field
    # the port's solver path: the JAX package's kernel path (which the JAX
    # package's own default takes on a TPU), with the whole-iteration
    # kernels as there
    assert ours.use_pallas_roundtrip and ours.use_pallas_detector
    assert ours.use_pallas_iteration == ref.use_pallas_iteration


@pytest.mark.parametrize("bands", [(500.0, 4000.0), (300.0, 3400.0), (1000.0, 2000.0)])
def test_in_band_bins_equal(bands):
    assert in_band_bins(16000, 1024, bands) == jax_in_band_bins(16000, 1024, bands)


def test_config_from_dict_reads_the_jax_key_names():
    cfg = AwareConfig.from_dict({
        "tolerance_db": 3.0, "embedding_bands": [600, 3000],
        "scheduler_cfg": {"name": "reduce_lr_on_plateau", "params": {"patience": 5}},
        "detection_net_cfg": {"n_filters": [512, 1024, 1024], "activation": "leaky_relu"},
        "verbose": False,
    })
    assert cfg.tolerance_db == 3.0 and cfg.embedding_bands == (600, 3000)
    assert cfg.sched_params == {"patience": 5}
    # "highest" (the default card file's) selects the float32 slab path;
    # "default" (the turbo card's single-pass bf16) loads, with scan_unroll
    assert AwareConfig.from_dict({"matmul_precision": "highest"}).matmul_precision == "highest"
    turbo = AwareConfig.from_dict({"matmul_precision": "default", "scan_unroll": 2})
    assert turbo.matmul_precision == "default" and turbo.scan_unroll == 2
    with pytest.raises(NotImplementedError, match="matmul_precision"):
        AwareConfig.from_dict({"matmul_precision": "fastest"})
    # every architecture field of the JAX schema loads, as the JAX package's
    arch = {"activation": "gelu", "norm_layer": "none", "final_activation": "sigmoid",
            "kernel_size": 3, "seed": 5}
    net = AwareConfig.from_dict({"detection_net_cfg": arch}).detection_net
    ref = JaxConfig.from_dict({"detection_net_cfg": arch}).detection_net
    assert dataclasses.asdict(net) == dataclasses.asdict(ref)
