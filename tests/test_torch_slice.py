"""The first slice as a whole: the port's batched embed against the JAX
package's ``embed_batch`` on the same path (round-trip kernels on, fused
detector off), then the port's public API end to end on the CPU (now on
the default path, the fused detector's: tests/test_torch_slice_detector.py
holds that path against the JAX package).

The embed loop is chaotic (fp differences amplify over the iterations),
so the solve is held at the outcome level, as ``tests/test_pallas.py``
holds the kernel path against the slab path: 0 % BER on every lane and
best losses within 0.02.  The first objective and its gradient, before
any amplification, are held tighter: the loss to 1e-4 relative, the
gradient to 5e-2 in relative L2 norm.  The forward rounds y2 to bf16
before the analysis, so ulp-level differences in the two packages' STFTs
(and hence in the out-of-band waveform) flip a few of those roundings,
and the detector's normalizations amplify that in the gradient.  Each
stage alone, given the same inputs, is held far tighter in its own test
(test_torch_kernels_roundtrip.py, test_torch_detector.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aware_tpu_torch
from aware_tpu.config import AwareConfig as JaxConfig
from aware_tpu.embed.solver import build_problem as jax_build_problem
from aware_tpu.embed.solver import embed_batch as jax_embed_batch
from aware_tpu.models import detect_values as jax_detect_values
from aware_tpu.models import init_params
from aware_tpu_torch.config import AwareConfig
from aware_tpu_torch.embed import solver
from aware_tpu_torch.models.detector import (
    DetectorNet,
    detect_values_batch,
    load_key_params,
    params_from_jax,
)
from aware_tpu_torch.ops.resample import resample

ITERS = 25
SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_cfg():
    return JaxConfig().replace(use_pallas_roundtrip=True, use_pallas_detector=False,
                               num_iterations=ITERS)


@pytest.fixture(scope="module")
def jax_params(jax_cfg):
    return {k: jnp.asarray(v) for k, v in init_params(jax_cfg.detection_net).items()}


@pytest.fixture(scope="module")
def net():
    return DetectorNet(params_from_jax(load_key_params()), AwareConfig().detection_net)


@pytest.fixture(scope="module")
def batch(speechlike):
    bits = np.random.default_rng(9).integers(0, 2, (2, 20))
    clips = np.stack([speechlike, np.roll(speechlike, 1234)])
    return clips, bits


def _ber(values, bits):
    return np.mean((np.asarray(values) > 0).astype(int) != bits, axis=-1)


def test_first_objective_and_gradient_match_jax(jax_cfg, jax_params, net, batch):
    clips, bits = batch
    wm = (2.0 * bits - 1.0).astype(np.float32)
    cfg = AwareConfig(use_pallas_detector=False)
    pb = solver.build_problem(net, torch.from_numpy(clips), torch.from_numpy(wm), cfg)
    assert pb.fused is None
    for i in range(2):
        jpb = jax_build_problem(jax_params, jnp.asarray(clips[i]), jnp.asarray(wm[i]), jax_cfg)
        objective_ct, to_carry = jpb.carry[0], jpb.carry[1]
        ct0 = to_carry(jpb.coeffs0)
        np.testing.assert_allclose(pb.ct0[i].numpy(), np.asarray(ct0), rtol=1e-5, atol=1e-5)
        jl, jg = jax.jit(jax.value_and_grad(objective_ct))(ct0)
        # both at the JAX package's starting point: an ulp of difference in
        # the coefficients can flip the bf16 rounding of their products
        ct = torch.from_numpy(np.array(ct0))[None].requires_grad_(True)
        sub = dataclasses.replace(
            pb, **{f: getattr(pb, f)[i : i + 1] for f in
                   ("ct0", "lower", "upper", "wm", "csin", "y_const", "mag", "phase")})
        loss = solver.objective(ct, sub, net, cfg)
        (grad,) = torch.autograd.grad(loss.sum(), ct)
        assert abs(loss.item() - float(jl)) <= 1e-4 * abs(float(jl))
        jg = np.asarray(jg)
        assert np.linalg.norm(grad[0].numpy() - jg) <= 5e-2 * np.linalg.norm(jg)


def test_embed_batch_matches_jax_outcome(jax_cfg, jax_params, net, batch):
    clips, bits = batch
    wm = (2.0 * bits - 1.0).astype(np.float32)
    ref = jax_embed_batch(jax_params, jnp.asarray(clips), jnp.asarray(wm), jax_cfg)
    ours = solver.embed_batch(net, torch.from_numpy(clips), torch.from_numpy(wm),
                              AwareConfig(num_iterations=ITERS, use_pallas_detector=False))
    audio = ours.audio.numpy()
    assert audio.shape == np.asarray(ref.audio).shape == (2, 125 * 256)
    assert np.all(np.isfinite(audio))
    assert np.all(_ber(detect_values_batch(net, ours.audio), bits) == 0.0)
    ref_values = np.stack([np.asarray(jax_detect_values(jax_params, a)) for a in ref.audio])
    assert np.all(_ber(ref_values, bits) == 0.0)
    # the JAX detector reads the port's embeds too
    jax_on_ours = np.stack([np.asarray(jax_detect_values(jax_params, jnp.asarray(a)))
                            for a in audio])
    assert np.all(_ber(jax_on_ours, bits) == 0.0)
    np.testing.assert_array_less(
        np.abs(ours.best_loss.numpy() - np.asarray(ref.best_loss)), 0.02)
    assert np.all(ours.best_loss.numpy() <= ours.final_loss.numpy() + 1e-6)
    assert ours.coeffs.shape == (2, 225, 126)


def test_solver_keeps_the_box_and_the_padding(net, batch):
    clips, bits = batch
    wm = torch.from_numpy((2.0 * bits - 1.0).astype(np.float32))
    cfg = AwareConfig(num_iterations=5)
    pb = solver.build_problem(net, torch.from_numpy(clips), wm, cfg)
    res = solver.embed_batch(net, torch.from_numpy(clips), wm, cfg)
    lower = pb.lower[..., : pb.nb].transpose(1, 2)
    upper = pb.upper[..., : pb.nb].transpose(1, 2)
    assert torch.all(res.coeffs >= lower) and torch.all(res.coeffs <= upper)
    assert torch.all(pb.upper[..., pb.nb :] == 0)


@pytest.fixture(scope="module")
def handles():
    return aware_tpu_torch.load(device="cpu", num_iterations=ITERS)


def test_load_sets_the_slice_configuration(handles):
    emb, det = handles
    assert emb.cfg.use_pallas_roundtrip and emb.cfg.use_pallas_detector
    assert emb.cfg.use_pallas_iteration
    assert emb.net is det.net and emb.device == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_public_api_roundtrip_16k(handles, speechlike):
    emb, det = handles
    bits = np.random.default_rng(1).integers(0, 2, 20)
    out = aware_tpu_torch.embed_watermark(speechlike, SR, bits, emb)
    assert out.shape == (125 * 256,) and np.all(np.isfinite(out))
    # signed-max rescale of the service contract
    assert np.isclose(np.max(np.abs(out)), abs(np.max(speechlike)), rtol=1e-5)
    np.testing.assert_array_equal(aware_tpu_torch.detect_watermark(out, SR, det), bits)


def test_public_api_roundtrip_44k(handles, speechlike):
    """Audio given at 44.1 kHz goes through the resample path both ways."""
    emb, det = handles
    clip = resample(torch.from_numpy(speechlike), SR, 44100).numpy()
    bits = np.random.default_rng(2).integers(0, 2, 20)
    out = aware_tpu_torch.embed_watermark(clip, 44100, bits, emb)
    assert out.shape == clip.shape and np.all(np.isfinite(out))
    np.testing.assert_array_equal(aware_tpu_torch.detect_watermark(out, 44100, det), bits)


def test_public_api_batch_roundtrip_with_a_silent_lane(handles, batch):
    emb, det = handles
    clips, bits = batch
    clips = np.concatenate([clips, np.zeros_like(clips[:1])])
    bits3 = np.concatenate([bits, bits[:1]])
    with pytest.raises(ValueError, match=r"\[2\]"):
        aware_tpu_torch.embed_watermark_batch(clips, SR, bits3, emb)
    out, mask = aware_tpu_torch.embed_watermark_batch(clips, SR, bits3, emb, on_silent="mask")
    np.testing.assert_array_equal(mask, [True, True, False])
    np.testing.assert_array_equal(out[2], clips[2, : out.shape[1]])
    got = aware_tpu_torch.detect_watermark_batch(out[:2], SR, det)
    np.testing.assert_array_equal(got, bits)


def test_public_api_stereo_merges_per_bit(handles, speechlike):
    emb, det = handles
    stereo = np.stack([speechlike, np.roll(speechlike, 500)], axis=1)
    bits = np.random.default_rng(3).integers(0, 2, 20)
    out = aware_tpu_torch.embed_watermark(stereo, SR, bits, emb)
    assert out.shape == (125 * 256, 2)
    np.testing.assert_array_equal(aware_tpu_torch.detect_watermark(out, SR, det), bits)


def test_service_rejects_bad_input(handles, speechlike):
    emb, _ = handles
    with pytest.raises(ValueError, match="watermark length"):
        aware_tpu_torch.embed_watermark(speechlike, SR, np.ones(7, int), emb)
    with pytest.raises(ValueError, match="speech"):
        aware_tpu_torch.embed_watermark(np.zeros(SR, np.float32), SR, np.ones(20, int), emb)
    with pytest.raises(ValueError, match="shape"):
        aware_tpu_torch.embed_watermark(np.zeros((4, 4, 4), np.float32), SR,
                                        np.ones(20, int), emb)


@pytest.mark.parametrize("overrides", [
    {"scheduler_name": "cosine_annealing"},
    {"optimizer_name": "adam"}, {"loss": "hinge"}, {"vad": "webrtc_gmm"},
    {"frame_length": 2048, "win_length": 2048},
])
def test_unported_paths_raise(overrides):
    with pytest.raises(NotImplementedError):
        aware_tpu_torch.load(device="cpu", **overrides)


@pytest.mark.parametrize("overrides", [
    {"matmul_precision": "default"},                   # the turbo card's precision
    {"matmul_precision": "default", "scan_unroll": 2},  # bench.py's configuration
])
def test_configurations_that_now_load(overrides):
    emb, det = aware_tpu_torch.load(device="cpu", **overrides)
    assert all(getattr(emb.cfg, k) == v for k, v in overrides.items())
    assert det.cfg is emb.cfg


def test_long_clips_name_the_tiled_kernels(net):
    long_clip = torch.zeros(1, 1030 * 256)
    pb = solver.build_problem(net, long_clip, torch.ones(1, 20), AwareConfig())
    assert pb.ct0.shape[1] == 1031 and pb.path == "tiled" and pb.tiled is not None


def test_card_file_is_read_by_path(tmp_path):
    card = tmp_path / "card.yaml"
    card.write_text("num_iterations: 7\ntolerance_db: 3.0\n"
                    "optimizer_cfg: {name: nadam, params: {lr: 0.05}}\n")
    emb, _ = aware_tpu_torch.load(card, device="cpu")
    assert emb.cfg.num_iterations == 7 and emb.cfg.opt_params == {"lr": 0.05}
    # EOT views: the robust card's keys load; the voice card's real host
    # codecs (eot_ste_codecs) are not ported, and the error names them
    robust = tmp_path / "robust.yaml"
    robust.write_text("eot_stretch_rates: [0.98, 1.02]\neot_pitch_cents: [-5.0, 5.0]\n"
                      "eot_mode: cycle\neot_weight: 2.0\n")
    emb, _ = aware_tpu_torch.load(robust, device="cpu")
    assert emb.cfg.eot_stretch_rates == (0.98, 1.02) and emb.cfg.eot_mode == "cycle"
    voice = tmp_path / "voice.yaml"
    voice.write_text("eot_ste_codecs: [opus_8k, gsm_fr]\n")
    with pytest.raises(NotImplementedError, match="eot_ste_codecs.*libopus, libgsm"):
        aware_tpu_torch.load(voice, device="cpu")
