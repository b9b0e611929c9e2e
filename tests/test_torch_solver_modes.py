"""Every solver mode of the card schema through the port's solver, against
the JAX package's, on the CPU (the kernels' wrappers run their plain
versions; the JAX kernels run in interpret mode).

* Path selection per mode, as the JAX gate (``aware_tpu/embed/solver.py:
  483-511``): a loss or optimizer other than push_extremes + NAdam without
  weight decay takes the ``iteration_forward`` kernels, a scheduler alone
  stays on ``iteration_step``; EOT views keep any mode off both.
* 10-iteration solves of two clips of T = 63 frames in each of the 20
  modes (six losses, eight optimizers, six schedules), against the JAX
  package's ``embed_batch`` on its kernel path: the embed loop is chaotic,
  so, as tests/test_torch_slice_iteration.py holds the whole-step path,
  best losses within 0.02 of JAX's.
* ``bce`` (NaN on tanh outputs: no step is ever better) and ``ber`` (no
  gradient) give back the unperturbed reconstruction in both packages.
* The EOT views take the card's loss: a robust-card view with
  ``loss: hinge`` against the JAX package's.
* L-BFGS: ``embed_batch`` refuses it, as JAX's ``embed_core`` does; a
  10-iteration ``embed_lbfgs`` of one clip against JAX's, and through the
  service's single-clip embed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aware_tpu_torch
from aware_tpu.config import AwareConfig as JaxConfig
from aware_tpu.embed import solver as jax_solver
from aware_tpu.models import init_params
from aware_tpu_torch.config import AwareConfig
from aware_tpu_torch.embed import solver
from aware_tpu_torch.models.detector import DetectorNet, load_key_params, params_from_jax
from test_torch_slice_detector import _speechlike

ITERS, FRAMES, LOSS_TOL = 10, 63, 0.02

LOSSES = ["hinge", "mse", "push_sigmoid", "sign", "bce", "ber"]
OPTIMIZERS = ["adam", "adamw", "sgd", "rmsprop", "adagrad", "adadelta", "adamax", "sparse_adam"]
# the chip check's schedules (chip_smoke.py phase 9), scaled to 10 iterations
SCHEDULES = {
    "cosine_annealing": {"T_max": 10},
    "cosine_annealing_warm_restarts": {"T_0": 3, "T_mult": 2},
    "step": {"step_size": 3, "gamma": 0.5},
    "multi_step": {"milestones": (2, 6), "gamma": 0.5},  # a tuple: JAX hashes its config
    "exponential": {"gamma": 0.8},
    "cyclic": {"base_lr": 0.01, "max_lr": 0.1, "step_size_up": 4, "mode": "triangular2"},
}
MODES = ([{"loss": name} for name in LOSSES]
         + [{"optimizer_name": name} for name in OPTIMIZERS]
         + [{"scheduler_name": k, "scheduler_params": v} for k, v in SCHEDULES.items()])


def _id(mode):
    return next(v for k, v in mode.items() if k != "scheduler_params")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net():
    return DetectorNet(params_from_jax(load_key_params()), AwareConfig().detection_net)


@pytest.fixture(scope="module")
def params():
    return {k: jnp.asarray(v) for k, v in init_params(JaxConfig().detection_net).items()}


@pytest.fixture(scope="module")
def batch():
    clip = _speechlike(4321)[: (FRAMES - 1) * 256]
    bits = np.random.default_rng(29).integers(0, 2, (2, 20))
    return np.stack([clip, np.roll(clip, 1234)]), (2.0 * bits - 1.0).astype(np.float32)


def _jax_cfg(**mode):
    return JaxConfig().replace(use_pallas_roundtrip=True, use_pallas_detector=True,
                               use_pallas_iteration=True, **mode)


@pytest.mark.parametrize("mode, path", [
    *[({"loss": name}, "iteration_forward") for name in LOSSES],
    *[({"optimizer_name": name}, "iteration_forward") for name in OPTIMIZERS + ["lbfgs"]],
    *[({"scheduler_name": k, "scheduler_params": v}, "iteration_step")
      for k, v in SCHEDULES.items()],
    ({"loss": "hinge", "eot_stretch_rates": (0.9,)}, "analysis_detector"),
    ({"optimizer_name": "adam", "use_pallas_iteration": False}, "analysis_detector"),
], ids=lambda v: _id(v) if isinstance(v, dict) else v)
def test_build_problem_selects_the_path_per_mode(net, mode, path):
    clip = torch.from_numpy(_speechlike(7)[None, : (FRAMES - 1) * 256])
    pb = solver.build_problem(net, clip, torch.ones(1, 20), AwareConfig(**mode))
    assert pb.path == path
    assert (pb.iteration is not None) == path.startswith("iteration")


@pytest.mark.parametrize("mode", MODES, ids=_id)
def test_ten_iterations_match_jax(net, params, batch, mode):
    clips, wm = batch
    ref = jax_solver.embed_batch(params, jnp.asarray(clips), jnp.asarray(wm),
                                 _jax_cfg(num_iterations=ITERS, **mode))
    ours = solver.embed_batch(net, torch.from_numpy(clips), torch.from_numpy(wm),
                              AwareConfig(num_iterations=ITERS, **mode))
    ref_best = np.asarray(ref.best_loss)
    assert ours.audio.shape == np.asarray(ref.audio).shape == (2, (FRAMES - 1) * 256)
    assert torch.isfinite(ours.audio).all()
    if mode.get("loss") == "bce":  # NaN every iteration: no best in either
        assert np.all(np.isinf(ref_best)) and torch.isinf(ours.best_loss).all()
        assert np.all(np.isnan(np.asarray(ref.final_loss))) and torch.isnan(ours.final_loss).all()
        return
    # ber counts sign mismatches, a step of 1/20: on these clips one bit's
    # detector value is 3e-5 from 0 at the start, and the kernels' bf16
    # sums (JAX's and the plain versions') land it on either side
    tol = 1.0 / 20 + 1e-6 if mode.get("loss") == "ber" else LOSS_TOL
    np.testing.assert_array_less(np.abs(ours.best_loss.numpy() - ref_best), tol)


@pytest.mark.parametrize("loss", ["bce", "ber"])
def test_bce_and_ber_give_back_the_unperturbed_reconstruction(net, params, batch, loss):
    clips, wm = batch
    x, w = torch.from_numpy(clips), torch.from_numpy(wm)
    ours = solver.embed_batch(net, x, w, AwareConfig(num_iterations=ITERS, loss=loss))
    start = solver.embed_batch(net, x, w, AwareConfig(num_iterations=0))
    torch.testing.assert_close(ours.audio, start.audio, rtol=0, atol=0)
    torch.testing.assert_close(ours.coeffs, start.coeffs, rtol=0, atol=0)
    cfg = _jax_cfg(num_iterations=ITERS, loss=loss)
    ref = jax_solver.embed_batch(params, jnp.asarray(clips), jnp.asarray(wm), cfg)
    for i in range(2):
        # JAX's best coefficients are its start's and its output their
        # reconstruction, to an ulp (its batched STFT and ISTFT round
        # apart from the one-clip calls by one)
        pb = jax_solver.build_problem(params, jnp.asarray(clips[i]), jnp.asarray(wm[i]), cfg)
        np.testing.assert_allclose(np.asarray(ref.coeffs[i]), np.asarray(pb.coeffs0),
                                   rtol=2.4e-7, atol=0)
        jax_start = np.asarray(jax_solver._reconstruct(pb, pb.coeffs0, cfg))
        np.testing.assert_allclose(np.asarray(ref.audio[i]), jax_start, rtol=0, atol=1e-6)
        np.testing.assert_allclose(ours.audio[i].numpy(), jax_start, rtol=0, atol=1e-5)


def test_a_robust_card_view_takes_the_cards_loss(net, params, batch):
    """A stretch view of the robust card under ``loss: hinge``: the port's
    view loss is hinge of its detector's bits, and within 1e-4 of the JAX
    package's view loss (stretch, peak-norm, STFT, the banded detector,
    hinge) on the same waveforms."""
    from aware_tpu.attacks.vocoder import time_stretch
    from aware_tpu.embed.losses import get_loss_fn
    from aware_tpu.models.detector import detector_apply_banded
    from aware_tpu.ops.stft import magphase, peak_normalize, stft
    from aware_tpu.ops.windows import get_window

    clips, wm = batch
    robust, _ = aware_tpu_torch.load("robust", device="cpu", loss="hinge")
    cfg = robust.cfg
    x, w = torch.from_numpy(clips), torch.from_numpy(wm)
    pb = solver.build_problem(net, x, w, cfg)
    assert pb.path == "analysis_detector"
    rate = cfg.eot_stretch_rates[0]
    ours = solver._view_loss(x, "ts", rate, pb, net, cfg)
    pushed = solver._view_loss(x, "ts", rate, pb, net, cfg.replace(loss="push_extremes"))
    assert not torch.allclose(ours, pushed)

    def jax_view(y, t):
        m2, _ = magphase(stft(peak_normalize(time_stretch(y, rate)), 1024, 256,
                              get_window("hann", 1024)))
        pred = detector_apply_banded(params, m2[pb.lo : pb.hi], pb.lo, pb.hi,
                                     JaxConfig().detection_net, cfg.matmul_precision)
        return get_loss_fn("hinge")(pred, t)

    ref = [float(jax_view(jnp.asarray(clips[i]), jnp.asarray(wm[i]))) for i in range(2)]
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_embed_batch_refuses_lbfgs(net, batch):
    clips, wm = batch
    with pytest.raises(ValueError, match="lbfgs"):
        solver.embed_batch(net, torch.from_numpy(clips), torch.from_numpy(wm),
                           AwareConfig(num_iterations=2, optimizer_name="lbfgs"))
    emb, _ = aware_tpu_torch.load(device="cpu", optimizer_name="lbfgs")
    with pytest.raises(ValueError, match="lbfgs"):
        aware_tpu_torch.embed_watermark_batch(clips, 16000, (wm > 0).astype(int), emb)


def test_embed_lbfgs_matches_jax(net, params, batch):
    """10 L-BFGS iterations of one clip through the problem's path (rows
    9-10's plain versions here, JAX's kernels in interpret mode there):
    best losses within 0.02, as the other modes, and below the start's
    loss; the service's single-clip embed dispatches here."""
    clips, wm = batch
    mode = {"optimizer_name": "lbfgs", "optimizer_params": {"lr": 0.5, "history_size": 5}}
    cfg = AwareConfig(num_iterations=ITERS, **mode)
    ours = solver.embed_lbfgs(net, torch.from_numpy(clips[0]), torch.from_numpy(wm[0]), cfg)
    ref = jax_solver.embed_lbfgs(params, jnp.asarray(clips[0]), jnp.asarray(wm[0]),
                                 _jax_cfg(num_iterations=ITERS, **mode))
    assert ours.audio.shape == np.asarray(ref.audio).shape == ((FRAMES - 1) * 256,)
    assert ours.coeffs.shape == np.asarray(ref.coeffs).shape
    assert abs(float(ours.best_loss) - float(ref.best_loss)) < LOSS_TOL
    pb = solver.build_problem(net, torch.from_numpy(clips[:1]), torch.from_numpy(wm[:1]), cfg)
    assert pb.path == "iteration_forward"
    with torch.no_grad():
        assert float(ours.best_loss) < float(solver.objective(pb.ct0, pb, net, cfg)[0])

    emb, _ = aware_tpu_torch.load(device="cpu", num_iterations=ITERS, **mode)
    out = emb.embed(clips[0], 16000, wm[0])
    np.testing.assert_array_equal(out, ours.audio.numpy())


def _sign_readings() -> None:
    """The sign loss's outcome at 400 iterations on six 2 s clips: the JAX
    package's float32 slab path (its CPU default), its kernel path
    (interpret mode) and the port's plain versions of that path, each
    lane's BER and smallest detector margin |value|.  The loss is 0 once
    every sign is right, so the best snapshot keeps margins of 1e-4 to
    1e-2, and the reconstruction can flip one (chip_smoke.py's
    MARGINLESS_MODES rests on this)."""
    from aware_tpu.models import detect_values
    from aware_tpu_torch.models.detector import detect_values_batch
    from chip_smoke import speechlike

    rng = np.random.default_rng(5)
    clips = np.stack([speechlike(rng, 2.0, 16000) for _ in range(6)])
    bits = rng.integers(0, 2, (6, 20))
    wm = (2.0 * bits - 1.0).astype(np.float32)
    params = {k: jnp.asarray(v) for k, v in init_params(JaxConfig().detection_net).items()}
    net = DetectorNet(params_from_jax(load_key_params()), AwareConfig().detection_net)

    def report(label, values):
        ber = np.mean((values > 0) != (bits > 0), axis=1) * 100
        print(f"{label}: BER % per lane {ber.tolist()}, smallest |value| per lane "
              + ", ".join(f"{v:.5f}" for v in np.abs(values).min(axis=1)))

    for label, cfg in (("JAX float32 slab path", JaxConfig().replace(loss="sign")),
                       ("JAX kernel path", _jax_cfg(loss="sign"))):
        ref = jax_solver.embed_batch(params, jnp.asarray(clips), jnp.asarray(wm), cfg)
        report(label, np.stack([np.asarray(detect_values(params, a)) for a in ref.audio]))
    ours = solver.embed_batch(net, torch.from_numpy(clips), torch.from_numpy(wm),
                              AwareConfig(loss="sign"))
    report("port, plain versions of the kernel path", detect_values_batch(net, ours.audio).numpy())


if __name__ == "__main__":
    _sign_readings()
