"""The third slice as a whole: the port's embed solver on the whole-step
path (``iteration_step`` per iteration, the default card's) and on the
``iteration_forward`` path (NAdam with weight decay), on the CPU, where the
kernels' wrappers run their plain versions.

* The port's paths against each other, 5 iterations at B = 2: the
  whole-step path and the iteration_forward path run the same plain
  operations in the same order as the two-kernel composition
  (``use_pallas_iteration=False``), so best_loss, the best coefficients and
  the final loss agree to 1e-6 relative (measured: bit for bit).
* The outcome against the JAX package's ``embed_batch`` with
  ``use_pallas_iteration=True`` (its whole-step kernel in interpret mode)
  for 25 iterations on two 2 s clips: the embed loop is chaotic, so, as
  tests/test_iteration.py holds the JAX kernel against the kernel path
  without it, 0 % BER on every lane and best losses within 0.02.
* The path selection of ``build_problem``, as the JAX package's
  (``aware_tpu/embed/solver.py:451-511``).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aware_tpu_torch
from aware_tpu.config import AwareConfig as JaxConfig
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
from aware_tpu_torch.ops.kernels import iteration as it
from test_torch_slice_detector import _speechlike

ITERS = 25
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net():
    return DetectorNet(params_from_jax(load_key_params()), AwareConfig().detection_net)


@pytest.fixture(scope="module")
def batch():
    bits = np.random.default_rng(29).integers(0, 2, (2, 20))
    clip = _speechlike(4321)
    return np.stack([clip, np.roll(clip, 1234)]), bits


def _ber(values, bits):
    return np.mean((np.asarray(values) > 0).astype(int) != bits, axis=-1)


@pytest.mark.parametrize("extra, path", [
    ({}, "iteration_step"),
    ({"optimizer_params": {"lr": 0.1, "weight_decay": 1e-4}}, "iteration_forward"),
])
def test_paths_agree_with_the_two_kernel_composition(net, batch, extra, path):
    clips, bits = batch
    x = torch.from_numpy(clips[:, : 40 * 256])
    wm = torch.from_numpy((2.0 * bits - 1.0).astype(np.float32))
    results = []
    for flag, want in ((True, path), (False, "analysis_detector")):
        cfg = AwareConfig(num_iterations=5, use_pallas_iteration=flag, **extra)
        assert solver.build_problem(net, x, wm, cfg).path == want
        results.append(solver.embed_batch(net, x, wm, cfg))
    ours, ref = results
    for name in ("best_loss", "final_loss", "coeffs", "audio"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max()), name


def test_embed_batch_matches_jax_outcome(net, batch):
    """Against the JAX package's whole-step kernel (interpret mode)."""
    clips, bits = batch
    wm = (2.0 * bits - 1.0).astype(np.float32)
    jax_cfg = JaxConfig().replace(use_pallas_roundtrip=True, use_pallas_detector=True,
                                  use_pallas_iteration=True, num_iterations=ITERS)
    params = {k: jnp.asarray(v) for k, v in init_params(jax_cfg.detection_net).items()}
    ref = jax_embed_batch(params, jnp.asarray(clips), jnp.asarray(wm), jax_cfg)
    cfg = AwareConfig(num_iterations=ITERS)
    assert solver.build_problem(net, torch.from_numpy(clips), torch.from_numpy(wm),
                                cfg).path == "iteration_step"
    ours = solver.embed_batch(net, torch.from_numpy(clips), torch.from_numpy(wm), cfg)
    audio = ours.audio.numpy()
    assert audio.shape == np.asarray(ref.audio).shape == (2, 125 * 256)
    assert np.all(np.isfinite(audio))
    assert np.all(_ber(detect_values_batch(net, ours.audio), bits) == 0.0)
    ref_values = np.stack([np.asarray(jax_detect_values(params, a)) for a in ref.audio])
    assert np.all(_ber(ref_values, bits) == 0.0)
    np.testing.assert_array_less(
        np.abs(ours.best_loss.numpy() - np.asarray(ref.best_loss)), 0.02)
    assert np.all(ours.best_loss.numpy() <= ours.final_loss.numpy() + 1e-6)


def test_the_solve_is_one_step_call_per_iteration(net, batch, monkeypatch):
    """The whole-step path calls iteration_step once per iteration and
    never the autograd objective."""
    clips, bits = batch
    calls = {"step": 0, "objective": 0}
    step, objective = solver.iteration_step, solver.objective

    def counting_step(*args, **kwargs):
        calls["step"] += 1
        return step(*args, **kwargs)

    def counting_objective(*args, **kwargs):
        calls["objective"] += 1
        return objective(*args, **kwargs)

    monkeypatch.setattr(solver, "iteration_step", counting_step)
    monkeypatch.setattr(solver, "objective", counting_objective)
    wm = torch.from_numpy((2.0 * bits - 1.0).astype(np.float32))
    res = solver.embed_batch(net, torch.from_numpy(clips[:, : 20 * 256]), wm,
                             AwareConfig(num_iterations=3))
    assert calls == {"step": 3, "objective": 0}
    assert torch.isfinite(res.best_loss).all()


@pytest.mark.parametrize("cfg, frames, path", [
    (AwareConfig(), 126, "iteration_step"),
    (AwareConfig(optimizer_params={"lr": 0.1, "weight_decay": 1e-4}), 126, "iteration_forward"),
    (AwareConfig(use_pallas_iteration=False), 126, "analysis_detector"),
    (AwareConfig(use_pallas_detector=False), 126, "band_analysis"),
    (AwareConfig(), 8, "iteration_step"),
    (AwareConfig(), 7, "band_analysis"),  # under the gate's 8 frames, as in JAX
])
def test_build_problem_selects_the_path(net, cfg, frames, path):
    clip = torch.from_numpy(_speechlike(7)[None, : (frames - 1) * 256])
    pb = solver.build_problem(net, clip, torch.ones(1, 20), cfg)
    assert pb.ct0.shape[1] == frames and pb.path == path
    assert (pb.iteration is not None) == path.startswith("iteration")
    assert (pb.fused is not None) == (path != "band_analysis")


def test_clips_over_1024_frames_still_raise(net):
    """Past 1024 frames the whole-step default takes the tiled path, not
    iteration_step, as the JAX package's gate does."""
    pb = solver.build_problem(net, torch.zeros(1, 1030 * 256), torch.ones(1, 20), AwareConfig())
    assert pb.path == "tiled" and pb.iteration is None and pb.fused is None


def test_load_defaults_to_the_whole_step_path():
    emb, _ = aware_tpu_torch.load(device="cpu")
    assert emb.cfg.use_pallas_iteration
    emb, _ = aware_tpu_torch.load(device="cpu", use_pallas_iteration=False)
    assert not emb.cfg.use_pallas_iteration


def test_bare_card_names_resolve_against_the_jax_cards():
    with pytest.raises(NotImplementedError, match="eot_stretch_rates"):
        aware_tpu_torch.load("robust", device="cpu")
    # the default card file pins matmul_precision: highest, which selects
    # the float32 slab path, as in the JAX package
    by_name, _ = aware_tpu_torch.load("config", device="cpu")
    by_path, _ = aware_tpu_torch.load(ROOT / "aware_tpu" / "cards" / "config.yaml", device="cpu")
    assert by_name.cfg == by_path.cfg and by_name.cfg.matmul_precision == "highest"
    clip = torch.zeros(1, 62 * 256)
    assert solver.build_problem(by_name.net, clip, torch.ones(1, 20), by_name.cfg).path == "slab"
    with pytest.raises(FileNotFoundError):
        aware_tpu_torch.load("no_such_card", device="cpu")


def test_detect_reads_the_whole_step_embed(net, batch):
    """The public API on the CPU (the plain versions of the kernels) embeds
    and reads back through the default path."""
    clips, bits = batch
    emb, det = aware_tpu_torch.load(device="cpu", num_iterations=ITERS)
    out = aware_tpu_torch.embed_watermark_batch(clips, 16000, bits, emb)
    np.testing.assert_array_equal(aware_tpu_torch.detect_watermark_batch(out, 16000, det), bits)
    assert it.KERNELS[2].launches == 0  # nothing launched on the CPU


if __name__ == "__main__":
    # The readings behind chip_smoke.py's short-clip bound (SHORT_LOSS_TOL):
    # how far the CPU plain solve's 10-iteration best loss moves when its
    # two clips move by 1e-6 of themselves, at 8, 9, 16 and 31 frames, on
    # the default and the first slice's path, six seeds.
    torch.set_num_threads(4)
    detector = DetectorNet(params_from_jax(load_key_params()), AwareConfig().detection_net)
    worst = {}
    for seed in range(6):
        rng = np.random.default_rng(seed)
        for frames in (8, 9, 16, 31):
            base = _speechlike(seed)[: (frames - 1) * 256]
            clips = np.stack([base, np.roll(_speechlike(seed + 100), 777)[: base.size]])
            moved = (clips * (1 + 1e-6 * rng.standard_normal(clips.shape))).astype(np.float32)
            wm = torch.as_tensor(2.0 * rng.integers(0, 2, (2, 20)) - 1.0, dtype=torch.float32)
            for label, cfg in (("default", AwareConfig(num_iterations=10)),
                               ("first slice", AwareConfig(num_iterations=10,
                                                           use_pallas_detector=False))):
                a = solver.embed_batch(detector, torch.from_numpy(clips), wm, cfg).best_loss
                b = solver.embed_batch(detector, torch.from_numpy(moved), wm, cfg).best_loss
                d = float((a - b).abs().max())
                worst[(frames, label)] = max(worst.get((frames, label), 0.0), d)
                print(f"seed {seed}, {frames} frames, {label}: |best_loss moved - best_loss| "
                      f"{d:.3e}", flush=True)
    print("largest:", {f"{f} frames {lab}": f"{v:.3e}" for (f, lab), v in worst.items()})
