"""The EOT cards' solve as a whole: a 30-iteration "cycle" embed of two
short speech-like clips on each of the robust, compression and desync
cards, the port's (``load(card, device="cpu")``: the "analysis_detector"
path, its kernels' plain versions) against the JAX package's
``embed_batch`` on the same card with the kernel round trip on, as
``load()`` sets it on a TPU (its Pallas kernels in interpret mode).

The loop is chaotic, so the solve is held at the outcome level, as
tests/test_torch_slice.py holds it: every lane reads back at 0 % BER
through the port's detector and through the JAX package's with the same
key, and the best losses agree within 0.02.

``PYTHONPATH=. python tests/test_torch_eot_outcome.py`` prints the CPU
plain robust-card solve's own spread on chip_smoke.py phase 7's reference
pairs (its EOT_LOSS_TOL): the 10-iteration best loss moved by moving the
clips by 1e-6 of themselves.
"""

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

import aware_tpu_torch
from aware_tpu.config import AwareConfig as JaxConfig
from aware_tpu.embed.solver import embed_batch as jax_embed_batch
from aware_tpu.models import detect_values as jax_detect_values
from aware_tpu.models import init_params
from aware_tpu_torch.embed import solver
from aware_tpu_torch.models.detector import detect_values_batch
from aware_tpu_torch.service.api import CARDS_DIR

ITERS = 30
SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _speechlike(seed: int) -> np.ndarray:
    """The suite's 2 s speech-like clip (tests/conftest.py), noise from ``seed``."""
    t = np.arange(2 * SR) / SR
    phase = np.cumsum(2 * np.pi * (120.0 + 30.0 * np.sin(2 * np.pi * 2.3 * t)) / SR)
    x = sum(np.cos(k * phase) / k for k in range(1, 25))
    x = x * (0.4 + 0.6 * np.clip(np.sin(2 * np.pi * 3.1 * t), 0, None))
    x = x + 0.02 * np.random.default_rng(seed).standard_normal(len(t))
    return (x / np.max(np.abs(x))).astype(np.float32)


def _ber(values, bits):
    return np.mean((np.asarray(values) > 0).astype(int) != bits, axis=-1)


@pytest.mark.parametrize("card", ["robust", "compression", "desync"])
def test_card_embed_matches_jax_outcome(card):
    emb, det = aware_tpu_torch.load(card, device="cpu", num_iterations=ITERS)
    assert emb.cfg.eot_mode == "cycle"
    card_dict = yaml.safe_load((CARDS_DIR / f"{card}.yaml").read_text())
    jax_cfg = JaxConfig.from_dict(card_dict).replace(num_iterations=ITERS,
                                                     use_pallas_roundtrip=True)
    jax_params = {k: jnp.asarray(v) for k, v in init_params(jax_cfg.detection_net).items()}
    clip = _speechlike(31)
    clips = np.stack([clip, np.roll(clip, 2345)])
    bits = np.random.default_rng(32).integers(0, 2, (2, 20))
    wm = (2.0 * bits - 1.0).astype(np.float32)

    x, w = torch.from_numpy(clips), torch.from_numpy(wm)
    assert solver.build_problem(det.net, x, w, emb.cfg).path == "analysis_detector"
    ours = solver.embed_batch(det.net, x, w, emb.cfg)
    ref = jax_embed_batch(jax_params, jnp.asarray(clips), jnp.asarray(wm), jax_cfg)
    audio = ours.audio.numpy()
    assert audio.shape == np.asarray(ref.audio).shape and np.all(np.isfinite(audio))
    assert np.all(_ber(detect_values_batch(det.net, ours.audio), bits) == 0.0)
    jax_on_ours = np.stack([np.asarray(jax_detect_values(jax_params, jnp.asarray(a)))
                            for a in audio])
    assert np.all(_ber(jax_on_ours, bits) == 0.0)
    np.testing.assert_array_less(
        np.abs(ours.best_loss.numpy() - np.asarray(ref.best_loss)), 0.02)


def _readings() -> None:
    """The CPU plain robust-card solve's own spread on chip_smoke.py phase
    7's reference pairs: 20 moves of the 2 s pair, 8 of the 1025-frame."""
    import chip_smoke

    torch.set_num_threads(8)
    rng = np.random.default_rng(0)  # phase 2-7's clips, from --seed 0
    clips = np.stack([chip_smoke.speechlike(rng, 10.0, SR) for _ in range(chip_smoke.BATCH)])
    bits = rng.integers(0, 2, (chip_smoke.BATCH, 20))
    r1025 = np.random.default_rng(1025)
    long = np.stack([chip_smoke.speechlike(r1025, 0.0, SR, samples=1024 * 256)
                     for _ in range(2)])
    emb, det = aware_tpu_torch.load("robust", device="cpu", num_iterations=10)
    wm = torch.as_tensor(2.0 * bits[:2] - 1.0, dtype=torch.float32)
    for label, pair, moves in (("2 s", clips[:2, : 2 * SR], 20), ("T = 1025", long, 8)):
        base = solver.embed_batch(det.net, torch.as_tensor(pair), wm, emb.cfg).best_loss
        spread = []
        for seed in range(100, 100 + moves):
            noise = np.random.default_rng(seed).standard_normal(pair.shape).astype(np.float32)
            moved = solver.embed_batch(det.net, torch.as_tensor(pair * (1 + 1e-6 * noise)), wm,
                                       emb.cfg).best_loss
            spread.append(float((moved - base).abs().max()))
        print(f"robust card, {label}: 10-iteration best loss {base.tolist()}; moved by 1e-6 "
              f"of the clips, |diff| max {max(spread):.4f} over {moves} moves, each "
              f"{[round(v, 4) for v in spread]}", flush=True)


if __name__ == "__main__":
    _readings()
