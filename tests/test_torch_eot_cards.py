"""The EOT cards in the port: the robust, desync and compression cards load
as the JAX package reads them, the voice card loads with its real-codec
views and fails at ``load()`` where a codec's library does not load,
naming it, the solver's gate keeps every problem with a view off the whole-iteration
kernels, the desync card's re-keyed detector reads as the JAX package's
with the same key, and a clip with a hard pause keeps the views' gradient
finite on every path."""

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

import aware_tpu_torch
from aware_tpu.config import AwareConfig as JaxConfig
from aware_tpu.config import DetectorNetConfig as JaxNetConfig
from aware_tpu.models import detect_values as jax_detect_values
from aware_tpu.models import init_params
from aware_tpu_torch.config import EOT_FIELDS, AwareConfig, DetectorNetConfig
from aware_tpu_torch.embed import solver
from aware_tpu_torch.models.detector import (
    KEY_DIR,
    DetectorNet,
    detect_values_batch,
    load_key_params,
    params_from_jax,
)
from aware_tpu_torch.service.api import CARDS_DIR

SR, HOP = 16000, 256
CARDS = ("robust", "desync", "compression")
RTOL, ATOL = 1e-4, 2e-5  # the detector's (tests/test_torch_detector.py)
VIEWS = {"eot_stretch_rates": (1.1,), "eot_pitch_cents": (-5.0,),
         "eot_mp3_qualities": (11,), "eot_celp_modes": ("nb8k",)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _speechlike(frames: int, seed: int) -> np.ndarray:
    t = np.arange((frames - 1) * HOP) / SR
    phase = np.cumsum(2 * np.pi * (120.0 + 30.0 * np.sin(2 * np.pi * 2.3 * t)) / SR)
    x = sum(np.cos(k * phase) / k for k in range(1, 25))
    x = x * (0.4 + 0.6 * np.clip(np.sin(2 * np.pi * 3.1 * t), 0, None))
    x = x + 0.02 * np.random.default_rng(seed).standard_normal(len(t))
    return (x / np.max(np.abs(x))).astype(np.float32)


@pytest.mark.parametrize("card", CARDS)
def test_cards_read_as_the_jax_package_reads_them(card):
    emb, det = aware_tpu_torch.load(card, device="cpu")
    ref = JaxConfig.from_dict(yaml.safe_load((CARDS_DIR / f"{card}.yaml").read_text()))
    cfg = emb.cfg
    hash(cfg)
    for field in (*EOT_FIELDS, "eot_weight", "eot_mode", "num_iterations", "tolerance_db",
                  "embedding_bands", "optimizer_params", "scheduler_params", "matmul_precision"):
        assert getattr(cfg, field) == getattr(ref, field), field
    assert cfg.detection_net.key_file == ref.detection_net.key_file
    assert solver.eot_views(cfg)
    # the JAX package's path on a TPU: the kernel round trip, high precision
    assert cfg.use_pallas_roundtrip and cfg.matmul_precision == "high"
    assert emb.net is det.net
    key = load_key_params(ref.detection_net.key_file)
    for name, value in key.items():
        np.testing.assert_array_equal(getattr(det.net, name).numpy(), value)


def test_the_desync_card_carries_its_own_key():
    emb, _ = aware_tpu_torch.load("desync", device="cpu")
    default, _ = aware_tpu_torch.load("robust", device="cpu")
    assert emb.cfg.detection_net.key_file == "desync_key_v1.npz"
    assert not torch.equal(emb.net.conv0_w, default.net.conv0_w)
    # a name under the key directory, or the same file by absolute path
    absolute = load_key_params(KEY_DIR / "desync_key_v1.npz")
    for name, value in load_key_params("desync_key_v1.npz").items():
        np.testing.assert_array_equal(absolute[name], value)


def test_voice_card_names_the_host_codecs(monkeypatch):
    """``load("voice")`` reads the card as the JAX package does, with its
    views in JAX's order; where a codec's library does not load
    (``_load_first`` monkeypatched), it raises RuntimeError at ``load()``
    naming that library."""
    from aware_tpu_torch.attacks import voice_codecs

    if not (voice_codecs.opus_available() and voice_codecs.gsm_available()):
        pytest.skip("libopus or libgsm is not installed on this machine")
    emb, det = aware_tpu_torch.load("voice", device="cpu")
    ref = JaxConfig.from_dict(yaml.safe_load((CARDS_DIR / "voice.yaml").read_text()))
    for field in (*EOT_FIELDS, "eot_weight", "eot_mode", "num_iterations", "tolerance_db",
                  "matmul_precision"):
        assert getattr(emb.cfg, field) == getattr(ref, field), field
    assert solver.eot_views(emb.cfg) == (("ste", "opus_8k"), ("ste", "gsm_fr"))
    assert emb.net is det.net and emb.cfg.use_pallas_roundtrip
    real = voice_codecs._load_first
    for absent, other in (("libopus", "libgsm"), ("libgsm", "libopus")):
        monkeypatch.setattr(voice_codecs, "_load_first",
                            lambda names, a=absent: None if names[0].startswith(a) else real(names))
        voice_codecs._opus.cache_clear()
        voice_codecs._gsm.cache_clear()
        with pytest.raises(RuntimeError, match=f"needs {absent}, which does not load") as err:
            aware_tpu_torch.load("voice", device="cpu")
        assert "eot_ste_codecs" in str(err.value) and other not in str(err.value)
    monkeypatch.undo()
    voice_codecs._opus.cache_clear()
    voice_codecs._gsm.cache_clear()
    assert aware_tpu_torch.load("voice", device="cpu")[0].cfg == emb.cfg


def test_a_detector_other_than_by_its_key_is_refused(tmp_path, speechlike):
    """A key bundle of another architecture (128 mel channels into conv0)
    under n_mels: 64: both packages load the card and raise at the first
    product that meets the key, the detection (JAX's dot_general a
    TypeError, torch's matmul a RuntimeError)."""
    from aware_tpu.service.api import load as jax_load

    card = tmp_path / "card.yaml"
    card.write_text("detection_net_cfg: {n_mels: 64, key_file: desync_key_v1.npz}\n")
    _, jdet = jax_load(str(card))
    _, det = aware_tpu_torch.load(card, device="cpu")
    assert det.cfg.detection_net == AwareConfig.from_dict(
        {"detection_net_cfg": {"n_mels": 64, "key_file": "desync_key_v1.npz"}}).detection_net
    with pytest.raises(TypeError, match="contracting dimensions"):
        jdet.detect(speechlike, 16000)
    with pytest.raises(RuntimeError, match="64"):
        det.detect(speechlike, 16000)


@pytest.mark.parametrize("field, value", [
    ("eot_mp3_qualities", (12,)), ("eot_celp_modes", ("wb32k",)),
    ("eot_ste_codecs", ("aac",)), ("eot_mode", "some"),
])
def test_eot_fields_are_validated(field, value):
    with pytest.raises(ValueError, match=field):
        AwareConfig(**{field: value})


def test_eot_lists_become_tuples():
    cfg = AwareConfig.from_dict({"eot_stretch_rates": [0.9, 1.1], "eot_celp_modes": ["nb8k"],
                                 "eot_weight": 0.5, "eot_mode": "cycle"})
    assert cfg.eot_stretch_rates == (0.9, 1.1) and cfg.eot_celp_modes == ("nb8k",)
    assert cfg.eot_weight == 0.5 and cfg.eot_mode == "cycle"
    hash(cfg)


@pytest.fixture(scope="module")
def net():
    return DetectorNet(params_from_jax(load_key_params()), AwareConfig().detection_net)


@pytest.mark.parametrize("flags, frames, with_views, without", [
    ({}, 126, "analysis_detector", "iteration_step"),
    ({"optimizer_params": {"lr": 0.1, "weight_decay": 1e-4}}, 126, "analysis_detector",
     "iteration_forward"),
    ({"use_pallas_detector": False}, 126, "band_analysis", "band_analysis"),
    ({}, 1030, "tiled", "tiled"),
])
def test_views_never_take_the_whole_iteration_kernels(net, flags, frames, with_views, without):
    x = torch.from_numpy(_speechlike(frames, 3))[None]
    wm = torch.ones(1, 20)
    for views, path in ((VIEWS, with_views), ({}, without)):
        for mode in ("cycle", "all"):
            pb = solver.build_problem(net, x, wm, AwareConfig(**flags, **views, eot_mode=mode))
            assert pb.path == path
            assert (pb.iteration is not None) == path.startswith("iteration_")


def test_cycle_wraps_over_two_views(net):
    """it = 2 is it = 0 again (the JAX check is tests/test_eot.py:82-107),
    it = 1 another view; "all" is their mean."""
    clip = torch.from_numpy(_speechlike(126, 4))[None]
    wm = torch.from_numpy(np.where(np.arange(20) % 3, 1.0, -1.0).astype(np.float32))[None]
    base = AwareConfig()
    cyc = base.replace(eot_stretch_rates=(0.9, 1.1), eot_mode="cycle")
    pb = solver.build_problem(net, clip, wm, cyc)
    pb_base = solver.build_problem(net, clip, wm, base.replace(use_pallas_iteration=False))
    with torch.no_grad():
        losses = [solver.objective(pb.ct0, pb, net, cyc, it).item() for it in range(3)]
        l_all = solver.objective(pb.ct0, pb, net, cyc.replace(eot_mode="all")).item()
        l_base = solver.objective(pb_base.ct0, pb_base, net, base).item()
    assert losses[2] == losses[0] and abs(losses[1] - losses[0]) > 1e-5
    np.testing.assert_allclose(l_all - l_base, np.mean([v - l_base for v in losses[:2]]),
                               rtol=1e-4)


def test_desync_key_detects_as_the_jax_package(speechlike):
    ours_net = DetectorNet(params_from_jax(load_key_params("desync_key_v1.npz")),
                           DetectorNetConfig(key_file="desync_key_v1.npz"))
    jax_params = {k: jnp.asarray(v)
                  for k, v in init_params(JaxNetConfig(key_file="desync_key_v1.npz")).items()}
    noise = np.random.default_rng(8).standard_normal(speechlike.shape).astype(np.float32)
    clips = np.stack([speechlike, np.roll(speechlike, 777), 0.3 * noise])
    ours = detect_values_batch(ours_net, torch.from_numpy(clips)).numpy()
    for clip, got in zip(clips, ours):
        np.testing.assert_allclose(got, np.asarray(jax_detect_values(jax_params, clip)),
                                   rtol=RTOL, atol=ATOL)


PAUSE_PATHS = {
    "analysis_detector": ({}, 63), "band_analysis": ({"use_pallas_detector": False}, 63),
    "tiled": ({}, 1025), "slab": ({"matmul_precision": "highest"}, 63),
    "frames": ({"use_slab_dft": False}, 63), "ola": ({"use_pallas_ola": True}, 63),
    "fft": ({"use_matmul_dft": False}, 63),
}


@pytest.mark.parametrize("path", list(PAUSE_PATHS))
def test_views_keep_the_gradient_finite_on_a_pause(net, path):
    """A clip whose first quarter is exactly zero: the views differentiate
    through phases (the vocoder's safe_angle, celp's angle) that are NaN-
    prone at exactly-zero bins (tests/test_eot.py:62-79, on every path)."""
    flags, frames = PAUSE_PATHS[path]
    n = (frames - 1) * HOP
    x = np.sin(2 * np.pi * 880 * np.arange(n) / SR).astype(np.float32)
    x[: n // 4] = 0.0
    cfg = AwareConfig(**flags, **VIEWS, eot_mode="all")
    pb = solver.build_problem(net, torch.from_numpy(x)[None], torch.ones(1, 20), cfg)
    assert pb.path == path
    ct = pb.ct0.clone().requires_grad_(True)
    loss = solver.objective(ct, pb, net, cfg)
    (grad,) = torch.autograd.grad(loss.sum(), ct)
    assert torch.isfinite(loss).all() and torch.isfinite(grad).all()
    assert grad.abs().sum() > 0
