"""The voice card in the port (``load("voice")``: ``eot_ste_codecs:
[opus_8k, gsm_fr]``, "cycle") against the JAX package, on the CPU, and the
extended eval.

* ``StraightThroughHost``: its forward is the codec round trip of each
  lane, its backward the identity (the JAX ``custom_jvp``), and it keeps
  y's dtype; ``HOST_VIEW_TIMES`` counts its calls and lanes.
* The card's views are JAX's, in JAX's order (read from the JAX problem's
  own ``eot_views``), and the card takes the "analysis_detector" path.
* ``_view_loss`` of ("ste", "opus_8k") and ("ste", "gsm_fr") and its
  gradient with respect to y against JAX's own ``_view_loss`` (the
  closure inside its ``build_problem``), on the same float32 waveform:
  both packages run the same codec on the same input, so the codec's
  output is the same to the bit, and what is left is the float32 STFT and
  detector after it: the loss to rtol 1e-4 (the views' bound of
  tests/test_torch_solver_modes.py), the gradient to 1e-3 in relative L2
  (measured 0 to 2.4e-7 on the loss, 5e-6 to 3.1e-5 on the gradient, on
  three clips at two levels, torch on one thread: ``PYTHONPATH=. python
  tests/test_torch_voice_card.py``).
  The two packages' own round trips cannot feed it: an ulp of input
  turns into another packet of the codec.
* A 4-iteration solve of one 2 s clip on the card, in both packages (the
  JAX one with its Pallas round trip in interpret mode, the port's on
  "analysis_detector"), held at the outcome, as
  tests/test_torch_eot_outcome.py holds the other EOT cards: 0 % BER
  through both packages' detectors, best losses within 0.02.
* A card name other than ``opus_<k>k`` / ``gsm_fr`` raises ValueError at
  ``load()``.
* ``eval --extended --cpu`` at one clip and 3 iterations gives one
  ``ber:`` key per row of the JAX extended suite.  The three filter rows
  (low_pass, high_pass, bandstop) are given a pass-through ``apply`` under
  their names here: their plain loops take a step a sample on the CPU
  (about 30 s a clip), and tests/test_torch_eval.py holds them.
"""

import json

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import aware_tpu.attacks.voice_codecs as jvc
import aware_tpu_torch
import aware_tpu_torch.attacks.attacks as port_attacks
from aware_tpu.config import AwareConfig as JaxConfig
from aware_tpu.embed.solver import build_problem as jax_build_problem
from aware_tpu.embed.solver import embed_batch as jax_embed_batch
from aware_tpu.models import detect_values as jax_detect_values
from aware_tpu.models import init_params
from aware_tpu_torch.attacks import voice_codecs as vc
from aware_tpu_torch.embed import solver
from aware_tpu_torch.eval import harness as ph
from aware_tpu_torch.models.detector import detect_values_batch
from aware_tpu_torch.service.api import CARDS_DIR

SR = 16000
ITERS = 4
LOSS_RTOL, GRAD_L2 = 1e-4, 1e-3
BASE_KEYS = {"clean_ber", "pesq", "pesq_proxy", "stoi", "snr"}
FILTER_ROWS = ("bandstop_200Hz", "low_pass", "high_pass")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _need_codecs() -> None:
    if not (vc.opus_available() and vc.gsm_available()):
        pytest.skip("libopus or libgsm is not installed on this machine")


def _speechlike(seed: int) -> np.ndarray:
    """The suite's 2 s speech-like clip (tests/conftest.py), noise from ``seed``."""
    t = np.arange(2 * SR) / SR
    phase = np.cumsum(2 * np.pi * (120.0 + 30.0 * np.sin(2 * np.pi * 2.3 * t)) / SR)
    x = sum(np.cos(k * phase) / k for k in range(1, 25))
    x = x * (0.4 + 0.6 * np.clip(np.sin(2 * np.pi * 3.1 * t), 0, None))
    x = x + 0.02 * np.random.default_rng(seed).standard_normal(len(t))
    return (x / np.max(np.abs(x))).astype(np.float32)


def _jax_card(**overrides) -> JaxConfig:
    card = yaml.safe_load((CARDS_DIR / "voice.yaml").read_text())
    return JaxConfig.from_dict(card).replace(**overrides)


def _cell(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


@pytest.fixture(scope="module")
def problem():
    _need_codecs()
    return _problem(41)


def _problem(seed: int):
    """(clip, bipolar target, the port's voice card, its problem, JAX's
    ``eot_views`` and ``_view_loss`` from its own problem on that clip)."""
    clip = _speechlike(seed)
    wm = (2.0 * np.random.default_rng(42).integers(0, 2, 20) - 1.0).astype(np.float32)
    emb, det = aware_tpu_torch.load("voice", device="cpu")
    pb = solver.build_problem(det.net, torch.from_numpy(clip[None]), torch.from_numpy(wm[None]),
                              emb.cfg)
    params = {k: jnp.asarray(v) for k, v in init_params(_jax_card().detection_net).items()}
    jpb = jax_build_problem(params, jnp.asarray(clip), jnp.asarray(wm), _jax_card())
    eot_loss = _cell(_cell(jpb.objective, "_obj_tail"), "eot_loss")
    view_loss = _cell(_cell(eot_loss, "branches")[0], "_view_loss")
    return clip, wm, emb, det, pb, _cell(eot_loss, "eot_views"), view_loss


@pytest.mark.parametrize("name", ["opus_8k", "gsm_fr"])
def test_the_straight_through_view_is_the_codec_forward_and_identity_backward(name):
    _need_codecs()
    lanes = np.stack([_speechlike(5), np.roll(_speechlike(6), 999)])[:, :SR]
    y = torch.tensor(lanes, dtype=torch.float64, requires_grad=True)
    solver.HOST_VIEW_TIMES.reset()
    out = solver._view(y, "ste", name, SR)
    assert out.dtype == torch.float64 and out.shape == y.shape
    want = [vc.gsm_roundtrip(a, SR) if name == "gsm_fr" else vc.opus_roundtrip(a, SR, 8000)
            for a in lanes.astype(np.float32)]
    np.testing.assert_array_equal(out.detach().numpy(), np.stack(want))
    g = torch.randn(y.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    (grad,) = torch.autograd.grad(out, y, g)
    assert torch.equal(grad, g)
    t = solver.HOST_VIEW_TIMES
    assert (t.calls, t.lanes) == (1, 2) and t.host_s > 0 and t.copy_s >= 0


def test_the_voice_cards_views_are_jaxs_in_jaxs_order(problem):
    _, _, emb, _, pb, jax_views, _ = problem
    assert solver.eot_views(emb.cfg) == jax_views == (("ste", "opus_8k"), ("ste", "gsm_fr"))
    assert emb.cfg.eot_mode == "cycle" and emb.cfg.matmul_precision == "high"
    assert pb.path == "analysis_detector"


def _view_spread(problem, name, scale=0.93):
    """(relative loss error, relative L2 gradient error) of the port's
    ``_view_loss`` against JAX's on the clip scaled by ``scale`` (a live
    waveform: under the peak, the round trip's length)."""
    clip, _, emb, det, pb, _, jax_view_loss = problem
    n = (pb.ct0.shape[1] - 1) * emb.cfg.hop_length
    y = clip[:n] * np.float32(scale)
    yt = torch.tensor(y[None], requires_grad=True)
    loss = solver._view_loss(yt, "ste", name, pb, det.net, emb.cfg)
    (grad,) = torch.autograd.grad(loss.sum(), yt)
    ref_loss, ref_grad = jax.jit(jax.value_and_grad(
        lambda a: jax_view_loss(a, "ste", name)))(jnp.asarray(y))
    ref = np.asarray(ref_grad, np.float64)
    return (abs(loss.item() - float(ref_loss)) / abs(float(ref_loss)),
            np.linalg.norm(grad[0].numpy() - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("name", ["opus_8k", "gsm_fr"])
def test_view_loss_and_gradient_match_jax_on_the_same_waveform(problem, name):
    d_loss, d_grad = _view_spread(problem, name)
    assert d_loss < LOSS_RTOL and d_grad < GRAD_L2


def test_a_short_voice_card_solve_matches_jax_outcome():
    _need_codecs()
    clip = _speechlike(41)[None]
    bits = np.random.default_rng(42).integers(0, 2, (1, 20))
    wm = (2.0 * bits - 1.0).astype(np.float32)
    emb, det = aware_tpu_torch.load("voice", device="cpu", num_iterations=ITERS)
    ours = solver.embed_batch(det.net, torch.from_numpy(clip), torch.from_numpy(wm), emb.cfg)
    jax_cfg = _jax_card(num_iterations=ITERS, use_pallas_roundtrip=True)
    params = {k: jnp.asarray(v) for k, v in init_params(jax_cfg.detection_net).items()}
    ref = jax_embed_batch(params, jnp.asarray(clip), jnp.asarray(wm), jax_cfg)
    audio = ours.audio.numpy()
    assert audio.shape == np.asarray(ref.audio).shape and np.all(np.isfinite(audio))
    assert np.all((detect_values_batch(det.net, ours.audio).numpy() > 0) == bits)
    assert np.all((np.asarray(jax_detect_values(params, jnp.asarray(audio[0]))) > 0) == bits[0])
    assert np.all((np.asarray(jax_detect_values(params, ref.audio[0])) > 0) == bits[0])
    np.testing.assert_array_less(np.abs(ours.best_loss.numpy() - np.asarray(ref.best_loss)), 0.02)


def test_a_codec_name_other_than_opus_or_gsm_raises_value_error(tmp_path):
    card = tmp_path / "card.yaml"
    card.write_text("eot_ste_codecs: [aac_64k]\n")
    with pytest.raises(ValueError, match="eot_ste_codecs"):
        aware_tpu_torch.load(card, device="cpu")
    with pytest.raises(ValueError, match="opus_<k>k or gsm_fr"):
        solver.ste_codec("opus_k", SR)


class _PassThrough:
    def __init__(self, name):
        self.name = name

    def apply(self, audio, sr, key=None, device=None):
        return audio


def test_eval_extended_names_the_jax_harness_rows(tmp_path, capsys, monkeypatch):
    suite = port_attacks.default_attack_suite
    monkeypatch.setattr(port_attacks, "default_attack_suite", lambda: [
        _PassThrough(a.name) if a.name in FILTER_ROWS else a for a in suite()])
    card = tmp_path / "card.yaml"
    card.write_text("num_iterations: 3\n")
    ph.main(["--extended", "--cpu", "--clips", "1", "--card", str(card)])
    captured = capsys.readouterr()
    res = json.loads(captured.out)
    assert set(res) == BASE_KEYS | {f"ber:{a.name}" for a in jvc.extended_attack_suite()}
    assert res["clean_ber"] == 0.0 and all(np.isfinite(v) for v in res.values())
    for name, _ in vc.extended_rows_left_out():
        assert f"row {name} left out" in captured.err


if __name__ == "__main__":
    # the readings of the module docstring: three clips at two levels
    torch.set_num_threads(1)
    for seed in (41, 43, 44):
        pair = _problem(seed)
        for name in ("opus_8k", "gsm_fr"):
            for scale in (0.93, 1.0):
                d_loss, d_grad = _view_spread(pair, name, scale)
                print(f"clip {seed} x {scale} {name}: loss {d_loss:.2e}, gradient L2 "
                      f"{d_grad:.2e}", flush=True)
