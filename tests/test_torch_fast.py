"""The amortized embedder and its serving path (``train/adversarial.py``'s
model half, ``service/fast.py``) against the JAX package on the CPU.

* ``embedder_apply`` on the repo's bundles: an MLP (amortized_v1_diverse),
  a U-Net (amortized_unet_speech), and a phase-conditioned MLP from the
  JAX package's ``init_embedder_params`` carried across.  Both sides are
  float32 with other convolution and reduction orders, so the outputs are
  held to 1e-5 of the magnitudes' scale (atol 2e-5 on magnitudes of order
  1-10; the tanh keeps a perturbation inside the box).
* ``init_embedder_params`` keys, shapes, bounds and identity taps as the
  JAX package's (its bits are not JAX's).
* ``embed_watermark_oneshot`` per variant against the JAX package's, and
  the tolerance resolution order: an explicit ``tolerance_db``, else the
  variant's trained box, else the card's; the 16 kHz and unknown-variant
  refusals.
* The warm start against ``embed_core(init_coeffs=...)``: at 0 iterations
  the output is the warm start clipped into the box and rebuilt, as the
  JAX package's ``_reconstruct`` of ``jnp.clip(init_coeffs, lower,
  upper)`` (held to 2e-5; ``embed_core`` itself cannot run 0 iterations),
  and a 3-iteration embed's best loss within the 2e-2 of
  tests/test_pallas.py:83; ``embed_watermark_turbo`` is the warm-started
  solve from the JAX package's amortized band, and ``embed_lbfgs`` starts
  where the batched solver does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aware_tpu_torch
from aware_tpu.embed.solver import _reconstruct as jax_reconstruct
from aware_tpu.embed.solver import build_problem as jax_build_problem
from aware_tpu.embed.solver import embed_core as jax_embed_core
from aware_tpu.models import init_params
from aware_tpu.config import AwareConfig as JaxConfig
from aware_tpu.service import fast as jax_fast
from aware_tpu.service.api import load as jax_load
from aware_tpu.train import adversarial as jadv
from aware_tpu_torch.config import AwareConfig, in_band_bins
from aware_tpu_torch.embed import solver
from aware_tpu_torch.models.detector import KEY_DIR
from aware_tpu_torch.ops.stft import magphase, peak_normalize, stft
from aware_tpu_torch.ops.windows import get_window
from aware_tpu_torch.service import fast
from aware_tpu_torch.train import adversarial as adv

SR = 16000
ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def handles():
    return aware_tpu_torch.load(device="cpu", num_iterations=3)


@pytest.fixture(scope="module")
def jax_handles():
    return jax_load(num_iterations=3)


def _speechlike(seconds: float, seed: int) -> np.ndarray:
    t = np.arange(int(seconds * SR)) / SR
    phase = np.cumsum(2 * np.pi * (130.0 + 25.0 * np.sin(2 * np.pi * 1.7 * t)) / SR)
    x = sum(np.cos(k * phase) / k for k in range(1, 25))
    x = x * (0.4 + 0.6 * np.clip(np.sin(2 * np.pi * 2.9 * t), 0, None))
    x = x + 0.02 * np.random.default_rng(seed).standard_normal(len(t))
    return (x / np.max(np.abs(x))).astype(np.float32)


def _band(clips: np.ndarray):
    """In-band magnitudes and phases (B, nb, T) of the default card."""
    cfg = AwareConfig()
    lo, hi = in_band_bins(SR, cfg.frame_length, cfg.embedding_bands)
    mag, phase = magphase(stft(peak_normalize(torch.from_numpy(clips)), cfg.frame_length,
                               cfg.hop_length, get_window(cfg.window, cfg.win_length)))
    return mag[:, lo:hi], phase[:, lo:hi]


def _bundle(name: str) -> dict:
    with np.load(KEY_DIR / name) as z:
        return {k: z[k] for k in z.files}


def _phase_mlp() -> dict:
    ecfg = jadv.AmortizedEmbedderConfig(hidden=(64, 48), phase_conditioned=True)
    return {k: np.asarray(v) for k, v in jadv.init_embedder_params(ecfg, 225, 20).items()}


@pytest.mark.parametrize("bundle", ["amortized_v1_diverse.npz", "amortized_unet_speech.npz",
                                    "phase_conditioned"])
def test_embedder_apply_matches_jax(bundle):
    params = _phase_mlp() if bundle == "phase_conditioned" else _bundle(bundle)
    clips = np.stack([_speechlike(1.0, 1), np.roll(_speechlike(1.0, 2), 300)])
    band, phase = _band(clips)
    pats = (2.0 * np.random.default_rng(4).integers(0, 2, (2, 20)) - 1.0).astype(np.float32)
    ours = adv.embedder_apply({k: torch.from_numpy(v) for k, v in params.items()}, band,
                              torch.from_numpy(pats), 6.0, band_phase=phase).numpy()
    for i in range(2):
        ref = np.asarray(jadv.embedder_apply(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(band[i].numpy()),
            jnp.asarray(pats[i]), 6.0, band_phase=jnp.asarray(phase[i].numpy())))
        np.testing.assert_allclose(ours[i], ref, atol=ATOL, rtol=1e-5)
        assert not np.allclose(ours[i], band[i].numpy())  # the bundle moves the band
    if bundle == "phase_conditioned":
        with pytest.raises(ValueError, match="band_phase"):
            adv.embedder_apply({k: torch.from_numpy(v) for k, v in params.items()}, band,
                               torch.from_numpy(pats), 6.0)


def test_odd_lengths_through_the_unet():
    """The U-Net's nearest upsample, right pad and crop at T odd and
    T = 2 mod 4 (the skip lengths differ from the upsampled ones)."""
    params = _bundle("amortized_unet_speech.npz")
    for frames in (37, 38):
        rng = np.random.default_rng(frames)
        band = rng.uniform(0.0, 3.0, (1, 225, frames)).astype(np.float32)
        pat = np.where(rng.random((1, 20)) < 0.5, -1.0, 1.0).astype(np.float32)
        ours = adv.embedder_apply({k: torch.from_numpy(v) for k, v in params.items()},
                                  torch.from_numpy(band), torch.from_numpy(pat), 3.0).numpy()
        ref = np.asarray(jadv.embedder_apply({k: jnp.asarray(v) for k, v in params.items()},
                                             jnp.asarray(band[0]), jnp.asarray(pat[0]), 3.0))
        np.testing.assert_allclose(ours[0], ref, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("ecfg", [
    jadv.AmortizedEmbedderConfig(hidden=(32, 16)),
    jadv.AmortizedEmbedderConfig(hidden=(32,), phase_conditioned=True, temporal_kernel=0),
    jadv.AmortizedEmbedderConfig(arch="unet", unet_channels=(8, 16, 32)),
], ids=["mlp", "phase", "unet"])
def test_init_params_as_the_jax_package(ecfg):
    ref = jadv.init_embedder_params(ecfg, 40, 20)
    ours = adv.init_embedder_params(adv.AmortizedEmbedderConfig(**vars(ecfg)), 40, 20)
    assert list(ours) == list(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert tuple(ours[k].shape) == v.shape and ours[k].dtype == torch.float32
        if k[0] == "t":  # identity temporal taps
            np.testing.assert_array_equal(ours[k].numpy(), v)
        elif k.endswith("_b") or k[0] == "b":
            assert not ours[k].any() and not v.any()
        else:  # the same uniform bound, not the same bits
            bound = np.abs(v).max()
            assert np.abs(ours[k].numpy()).max() <= bound * 1.02
            assert np.abs(ours[k].numpy()).max() >= bound * 0.9


@pytest.mark.parametrize("variant", sorted(fast._VARIANTS))
def test_oneshot_per_variant_matches_jax(handles, jax_handles, variant):
    clip = _speechlike(1.5, 7) * 0.8
    bits = np.random.default_rng(11).integers(0, 2, 20)
    ours = fast.embed_watermark_oneshot(clip, SR, bits, handles[0], variant=variant)
    ref = np.asarray(jax_fast.embed_watermark_oneshot(clip, SR, bits, jax_handles[0],
                                                      variant=variant))
    assert ours.shape == ref.shape == ((len(clip) // 256) * 256,)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_tolerance_resolution_order(handles, jax_handles):
    """An explicit tolerance_db, then the variant's trained box (2 dB for
    "default"), then the card's tolerance_db (6 dB, for "diverse")."""
    clip = _speechlike(1.0, 8)
    bits = np.random.default_rng(12).integers(0, 2, 20)
    emb = handles[0]

    def one(variant, tol=None):
        return fast.embed_watermark_oneshot(clip, SR, bits, emb, variant=variant,
                                            tolerance_db=tol)

    np.testing.assert_array_equal(one("default"), one("default", 2.0))
    np.testing.assert_array_equal(one("diverse"), one("diverse", 6.0))
    assert not np.array_equal(one("default"), one("default", 6.0))
    ref = np.asarray(jax_fast.embed_watermark_oneshot(clip, SR, bits, jax_handles[0],
                                                      variant="default", tolerance_db=3.5))
    np.testing.assert_allclose(one("default", 3.5), ref, atol=ATOL)


def test_oneshot_refusals(handles):
    clip = _speechlike(1.0, 9)
    bits = np.ones(20, int)
    with pytest.raises(ValueError, match="16 kHz"):
        fast.embed_watermark_oneshot(clip, 44100, bits, handles[0])
    with pytest.raises(ValueError, match="16 kHz"):
        fast.embed_watermark_turbo(clip, 22050, bits, handles[0])
    with pytest.raises(FileNotFoundError, match="no_such"):
        fast.embed_watermark_oneshot(clip, SR, bits, handles[0], variant="no_such")
    with pytest.raises(ValueError, match="watermark length"):
        fast.embed_watermark_oneshot(clip, SR, np.ones(7, int), handles[0])


def _warm(clip, bits, variant="diverse", tol=None):
    """The JAX package's warm start for one clip: the amortized band."""
    jemb = jax_load(num_iterations=1)[0]
    band, *_ = jax_fast._amortized_band(jemb, clip, 2.0 * bits - 1.0, variant, tol)
    return np.asarray(band)


@pytest.mark.parametrize("flags", [{}, {"matmul_precision": "highest"}],
                         ids=["iteration_step", "slab"])
def test_warm_start_matches_embed_core(handles, flags):
    clip = _speechlike(1.0, 10)
    bits = np.random.default_rng(13).integers(0, 2, 20)
    wm = (2.0 * bits - 1.0).astype(np.float32)
    # a warm start that leaves the box in places, so that the clip matters
    warm = _warm(clip, bits, "diverse", 1.0)
    params = {k: jnp.asarray(v) for k, v in init_params(JaxConfig().detection_net).items()}
    net = handles[0].net
    for iters in (0, 3):
        cfg = AwareConfig(num_iterations=iters, **flags)
        jcfg = JaxConfig().replace(use_pallas_roundtrip=True, num_iterations=max(iters, 1),
                                   **flags)
        if iters:
            ref = jax_embed_core(params, jnp.asarray(clip), jnp.asarray(wm), jcfg,
                                 init_coeffs=jnp.asarray(warm))
        else:
            jpb = jax_build_problem(params, jnp.asarray(clip), jnp.asarray(wm), jcfg)
            coeffs = jnp.clip(jnp.asarray(warm), jpb.lower, jpb.upper)
            ref = solver.EmbedResult(jax_reconstruct(jpb, coeffs, jcfg), None, None, coeffs)
        pb_path = solver.build_problem(net, torch.from_numpy(clip[None]),
                                       torch.from_numpy(wm[None]), cfg).path
        assert pb_path == ("slab" if flags else "iteration_step")
        ours = solver.embed_batch(net, torch.from_numpy(clip[None]), torch.from_numpy(wm[None]),
                                  cfg, init_coeffs=torch.from_numpy(warm[None]))
        if iters == 0:
            np.testing.assert_allclose(ours.coeffs[0].numpy(), np.asarray(ref.coeffs),
                                       atol=ATOL, rtol=1e-5)
            np.testing.assert_allclose(ours.audio[0].numpy(), np.asarray(ref.audio), atol=ATOL)
            # the start is the warm band inside the box, not the magnitudes
            cold = solver.embed_batch(net, torch.from_numpy(clip[None]),
                                      torch.from_numpy(wm[None]), cfg)
            assert not torch.allclose(cold.coeffs, ours.coeffs)
        else:
            assert abs(float(ours.best_loss[0]) - float(ref.best_loss)) < 2e-2


def test_turbo_and_lbfgs_from_a_warm_start(handles):
    clip = _speechlike(1.0, 14) * 0.9
    bits = np.random.default_rng(15).integers(0, 2, 20)
    wm = torch.from_numpy((2.0 * bits - 1.0).astype(np.float32))
    band, *_ = fast._amortized_band(handles[0], clip, wm.numpy(), "default")
    np.testing.assert_allclose(band.numpy(), _warm(clip, bits, "default"), atol=ATOL, rtol=1e-5)
    for iters in (0, 2):
        ours = fast.embed_watermark_turbo(clip, SR, bits, handles[0], num_iterations=iters)
        res = solver.embed_batch(handles[0].net, torch.from_numpy(clip[None]), wm[None],
                                 AwareConfig(num_iterations=iters), init_coeffs=band[None])
        np.testing.assert_array_equal(ours, res.audio[0].numpy() * np.max(clip))
    warm = torch.from_numpy(_warm(clip, bits))
    cfg = AwareConfig(optimizer_name="lbfgs", num_iterations=0)
    res = solver.embed_lbfgs(handles[0].net, torch.from_numpy(clip), wm, cfg, init_coeffs=warm)
    batch = solver.embed_batch(handles[0].net, torch.from_numpy(clip[None]), wm[None],
                               AwareConfig(num_iterations=0), init_coeffs=warm[None])
    np.testing.assert_array_equal(res.coeffs.numpy(), batch.coeffs[0].numpy())
