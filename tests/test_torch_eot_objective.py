"""The EOT views in the solver: the first objective and its gradient with
views on, the port's against the JAX package's ``build_problem`` on the
same flags, on every path that can carry a view.  This file holds the
kernel paths ("analysis_detector", the EOT cards' default; "band_analysis";
"tiled" at 1025 frames), tests/test_torch_eot_objective_plain.py the
float32 round trips ("slab", "frames", "ola", "fft"); the JAX Pallas
kernels run in interpret mode.

Four views, one of each kind (vocoder time stretch 0.9, pitch shift +5
cents, mp3_approx quality 11, celp_approx nb8k, weight 2), in "cycle" at
it = 0..3 (one view each) and 4 (= 0 again), and in "all" (their mean),
at the JAX package's starting coefficients, on two 2 s clips (B = 2, one
batched call of the port against the JAX objective per clip), and one
1025-frame clip on "tiled".

Bounds.  The existing first-step bounds, the kernel paths' 1e-4 on the
loss and the float32 paths' LOSS_TOL = 1e-5 and GRAD_TOL = 1e-3
(tests/test_torch_slice.py, tests/test_torch_slice_xla.py), hold where the
JAX reference holds them itself: the mp3 view on the float32 paths
(measured 8e-8 and 1.3e-5).  Elsewhere the views make the float32
objective ill-conditioned in the JAX package itself, and the port is held
to the JAX package's own spread, as tests/test_torch_slice_detector.py
holds the bf16 detector's: the loss to 1e-4 relative on every path, the
gradient to VIEW_GRAD = 0.3 in relative L2 and VIEW_COS = 0.05 in
1 - cosine.  A 1e-6 move of the JAX coefficients moves the JAX loss by
up to 1.3e-4 (a celp view: its envelope quantizer rounds) and the
gradient by up to 0.18 (1 - cosine 0.017); the port against JAX measured
up to 7.1e-5, 0.22 and 0.024 (the readings below).  The vocoder's float32
gradient is far from its float64 value in the JAX package alone (7.0-7.3 %
relative L2 for a stretch view's loss: the phase accumulated over the
frames reaches 1e5 rad, where a float32 ulp is 0.008 rad, and the reverse
cumsum of its VJP cancels; tests/test_torch_eot_views.py's readings).  The
views themselves agree with the JAX package's in float64 to 5e-8
(tests/test_torch_eot_views.py).

The voice card's two views (the real codecs opus_8k and gsm_fr on the
host, straight through; "cycle" at it = 0..2 and "all") on
"analysis_detector".  The codec turns an ulp of its input into another
packet, so the two packages' round trips feed it waveforms that differ
by an ulp and get back outputs that differ by far more: there the port is
held at the JAX package's own spread, measured as above, VOICE_LOSS =
2e-2 relative on the loss, VOICE_GRAD = 1.0 in relative L2 and VOICE_COS
= 0.5 in 1 - cosine on the gradient (the port against JAX measured up to
8.1e-3, 0.76 and 0.275; JAX's own under a 1e-6 move up to 1.0e-2, 0.77 and
0.29).  With the codecs' output pinned, one output a clip in both packages
(``pinned_codecs``), the decisions are the same and the views are held at
the other views' bounds (measured up to 4.6e-5, 0.15 and 0.012): what is
left is the straight-through plumbing.

``PYTHONPATH=. python tests/test_torch_eot_objective.py`` prints the
readings of all seven paths, then of the voice card's views with real and
with pinned codecs, beside the JAX objective's own move under a 1e-6 move
of its coefficients.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aware_tpu.config import AwareConfig as JaxConfig
from aware_tpu.embed.solver import build_problem as jax_build_problem
from aware_tpu.models import init_params
from aware_tpu_torch.config import AwareConfig
from aware_tpu_torch.embed import solver
from aware_tpu_torch.models.detector import DetectorNet, load_key_params, params_from_jax

SR, HOP = 16000, 256
VIEWS = {"eot_stretch_rates": (0.9,), "eot_pitch_cents": (5.0,),
         "eot_mp3_qualities": (11,), "eot_celp_modes": ("nb8k",), "eot_weight": 2.0}
LOSS_TOL, GRAD_TOL = 1e-5, 1e-3    # the float32 paths' (test_torch_slice_xla.py)
VIEW_LOSS = 1e-4                    # the kernel paths' (test_torch_slice.py)
VIEW_GRAD, VIEW_COS = 0.3, 0.05     # relative L2, 1 - cosine
VOICE_LOSS, VOICE_GRAD, VOICE_COS = 2e-2, 1.0, 0.5  # the real codecs' (module docstring)
# path: (the port's flags, the JAX package's flags, frames, clips)
PATHS = {
    "analysis_detector": ({}, {"use_pallas_roundtrip": True}, 126, 2),
    "band_analysis": ({"use_pallas_detector": False},
                      {"use_pallas_roundtrip": True, "use_pallas_detector": False}, 126, 2),
    "tiled": ({}, {"use_pallas_roundtrip": True}, 1025, 1),
    "slab": ({"matmul_precision": "highest"}, {"matmul_precision": "highest"}, 126, 2),
    "frames": ({"use_slab_dft": False}, {"use_slab_dft": False}, 126, 2),
    "ola": ({"use_pallas_ola": True}, {"use_pallas_ola": True}, 126, 2),
    "fft": ({"use_matmul_dft": False}, {"use_matmul_dft": False}, 126, 2),
}
KERNEL_PATHS = ("analysis_detector", "band_analysis", "tiled")
# the voice card's views: the real codecs on the host, straight through
VOICE_VIEWS = {"eot_ste_codecs": ("opus_8k", "gsm_fr"), "eot_weight": 1.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_net() -> DetectorNet:
    return DetectorNet(params_from_jax(load_key_params()), AwareConfig().detection_net)


def make_jax_params() -> dict:
    return {k: jnp.asarray(v) for k, v in init_params(JaxConfig().detection_net).items()}


def speechlike(frames: int, seed: int) -> np.ndarray:
    """A speech-like clip of ``frames`` STFT frames, the suite's harmonic
    fixture with noise from ``seed``."""
    t = np.arange((frames - 1) * HOP) / SR
    phase = np.cumsum(2 * np.pi * (120.0 + 30.0 * np.sin(2 * np.pi * 2.3 * t)) / SR)
    x = sum(np.cos(k * phase) / k for k in range(1, 25))
    x = x * (0.4 + 0.6 * np.clip(np.sin(2 * np.pi * 3.1 * t), 0, None))
    x = x + 0.02 * np.random.default_rng(seed).standard_normal(len(t))
    return (x / np.max(np.abs(x))).astype(np.float32)


def _jax_value_and_grad(jax_params, clip, wm, jax_cfg):
    """(JAX's starting coefficients in the layout its objective takes, the
    jitted value_and_grad of that objective over (coefficients, it), and
    whether that layout is the padded time-major carry)."""
    jpb = jax_build_problem(jax_params, jnp.asarray(clip), jnp.asarray(wm), jax_cfg)
    if jpb.carry is not None:
        objective, to_carry = jpb.carry[0], jpb.carry[1]
        return np.array(to_carry(jpb.coeffs0)), jax.jit(jax.value_and_grad(objective)), True
    return np.array(jpb.coeffs0), jax.jit(jax.value_and_grad(jpb.objective)), False


def first_steps(net, jax_params, path, mode, its, move=0.0, views=VIEWS):
    """Per clip and ``it``: (JAX loss, JAX gradient, the port's loss and
    gradient at JAX's starting coefficients, with ``move`` JAX's own at
    them moved by ``move`` of themselves, else None), in the (T, nb)
    layout."""
    flags, jax_flags, frames, n_clips = PATHS[path]
    clips = np.stack([speechlike(frames, 21 + i) for i in range(n_clips)])
    if n_clips > 1:
        clips[1] = np.roll(clips[1], 777)
    bits = np.random.default_rng(frames).integers(0, 2, (n_clips, 20))
    wm = (2.0 * bits - 1.0).astype(np.float32)
    cfg = AwareConfig(**flags, **views, eot_mode=mode)
    pb = solver.build_problem(net, torch.from_numpy(clips), torch.from_numpy(wm), cfg)
    assert pb.path == path
    jax_cfg = JaxConfig().replace(**jax_flags, **views, eot_mode=mode)
    starts, out = [], {it: [] for it in its}
    for i in range(n_clips):
        c0, value_and_grad, carry = _jax_value_and_grad(jax_params, clips[i], wm[i], jax_cfg)
        assert carry == (path in KERNEL_PATHS)
        starts.append(c0 if carry else c0.T)
        for it in its:
            jl, jg = value_and_grad(jnp.asarray(c0), jnp.int32(it))
            moved = None
            if move:
                noise = np.random.default_rng(it).standard_normal(c0.shape).astype(np.float32)
                ml, mg = value_and_grad(jnp.asarray(c0 * (1 + move * noise)), jnp.int32(it))
                moved = (float(ml), np.asarray(mg, np.float64))
            jg = np.asarray(jg, np.float64)
            out[it].append([float(jl), jg if carry else jg.T, moved and (
                moved[0], moved[1] if carry else moved[1].T)])
    ct = torch.zeros_like(pb.ct0)
    starts = torch.from_numpy(np.stack(starts))
    ct[..., : starts.shape[-1]] = starts
    rows = []
    for it in its:
        leaf = ct.clone().requires_grad_(True)
        loss = solver.objective(leaf, pb, net, cfg, it)
        (grad,) = torch.autograd.grad(loss.sum(), leaf)
        assert torch.all(grad[..., pb.nb :] == 0)  # the padding columns stay 0
        for i, (jl, jg, moved) in enumerate(out[it]):
            g = grad[i, :, : jg.shape[-1]].numpy().astype(np.float64)
            rows.append((it, i, jl, jg, loss[i].item(), g, moved))
    return rows


def spread(loss, grad, ref_loss, ref_grad):
    """(relative loss error, relative L2 gradient error, 1 - cosine)."""
    a, b = grad.ravel(), ref_grad.ravel()
    return (abs(loss - ref_loss) / abs(ref_loss), np.linalg.norm(a - b) / np.linalg.norm(b),
            1 - a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def view_kind(mode: str, it: int, views=VIEWS) -> str:
    kinds = [f"{kind} {value}" if kind == "ste" else kind
             for kind, value in solver.eot_views(AwareConfig(**views))]
    return "all" if mode == "all" else kinds[it % len(kinds)]


def check_path(net, jax_params, path, views=VIEWS, real_codecs=True):
    """Both modes on ``path``, at their bounds (module docstring); the
    voice card's views at VOICE_* where ``real_codecs``."""
    n_views = len(solver.eot_views(AwareConfig(**views)))
    for mode, its in (("cycle", tuple(range(n_views + 1))), ("all", (0,))):
        rows = first_steps(net, jax_params, path, mode, its, views=views)
        for it, i, jl, jg, loss, grad, _ in rows:
            kind = view_kind(mode, it, views)
            dl, dg, dcos = spread(loss, grad, jl, jg)
            if kind == "mp3" and path not in KERNEL_PATHS:
                ok = dl <= LOSS_TOL and dg <= GRAD_TOL
            elif "eot_ste_codecs" in views and real_codecs:
                ok = dl <= VOICE_LOSS and dg <= VOICE_GRAD and dcos <= VOICE_COS
            else:
                ok = dl <= VIEW_LOSS and dg <= VIEW_GRAD and dcos <= VIEW_COS
            assert ok, (path, mode, it, i, kind, dl, dg, dcos)
        if mode == "cycle":
            # the rotation wraps: it = n_views is view 0 again, bit for bit
            by_it = {(it, i): (loss, grad) for it, i, _, _, loss, grad, _ in rows}
            for i in range(PATHS[path][3]):
                assert by_it[(n_views, i)][0] == by_it[(0, i)][0]
                np.testing.assert_array_equal(by_it[(n_views, i)][1], by_it[(0, i)][1])
                assert by_it[(1, i)][0] != by_it[(0, i)][0]


@contextlib.contextmanager
def pinned_codecs(path):
    """Both packages' real-codec views given one fixed output a clip: the
    real codec's round trip of the peak-normalized clip (about the live
    waveform at the starting coefficients), picked for a lane by its
    correlation with the lane.  The codecs' decisions are then the same
    in both packages, and what is left is the straight-through plumbing."""
    import aware_tpu.attacks.voice_codecs as jax_codecs
    from aware_tpu_torch.attacks import voice_codecs as codecs

    frames, n_clips = PATHS[path][2], PATHS[path][3]
    refs = [speechlike(frames, 21 + i) for i in range(n_clips)]
    if n_clips > 1:
        refs[1] = np.roll(refs[1], 777)
    refs = [r / np.max(np.abs(r)) for r in refs]
    outs = {"opus": [codecs.opus_roundtrip(r, SR, 8000) for r in refs],
            "gsm": [codecs.gsm_roundtrip(r, SR) for r in refs]}

    def pick(kind, a):
        a = np.asarray(a, np.float32)
        return outs[kind][int(np.argmax([a @ r for r in refs]))].copy()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_codecs, "opus_roundtrip", lambda a, sr, bps=0, voip=True: pick("opus", a))
        mp.setattr(jax_codecs, "gsm_roundtrip", lambda a, sr: pick("gsm", a))
        mp.setattr(solver, "ste_codec",
                   lambda name, sr: functools.partial(pick, name.split("_")[0]))
        yield


def _need_voice_codecs():
    from aware_tpu_torch.attacks import voice_codecs as codecs

    if not (codecs.opus_available() and codecs.gsm_available()):
        pytest.skip("libopus or libgsm is not installed on this machine")


@pytest.mark.parametrize("path, views", [(p, VIEWS) for p in KERNEL_PATHS]
                         + [("analysis_detector", VOICE_VIEWS)],
                         ids=list(KERNEL_PATHS) + ["analysis_detector-voice"])
def test_first_objective_and_gradient_with_views_match_jax(path, views):
    if views is VOICE_VIEWS:
        _need_voice_codecs()
    check_path(make_net(), make_jax_params(), path, views)


def test_voice_views_with_the_codec_output_pinned_match_jax():
    """The voice card's views with one codec output a clip in both packages
    (``pinned_codecs``): the first objective and its gradient at the other
    views' bounds."""
    _need_voice_codecs()
    with pinned_codecs("analysis_detector"):
        check_path(make_net(), make_jax_params(), "analysis_detector", VOICE_VIEWS,
                   real_codecs=False)


def readings(paths, views=VIEWS, label="") -> None:
    """The first objective and gradient against JAX's on ``paths``, beside
    JAX's own move under a 1e-6 move of its coefficients."""
    net, params = make_net(), make_jax_params()
    n_views = len(solver.eot_views(AwareConfig(**views)))
    for path in paths:
        for mode, its in (("cycle", tuple(range(n_views))), ("all", (0,))):
            for it, i, jl, jg, loss, grad, (ml, mg) in first_steps(
                    net, params, path, mode, its, 1e-6, views=views):
                dl, dg, dcos = spread(loss, grad, jl, jg)
                ol, og, ocos = spread(ml, mg, jl, jg)
                print(f"{path}{label} {mode} it {it} ({view_kind(mode, it, views)}) clip {i}: "
                      f"loss {dl:.2e} (JAX's own {ol:.2e}); gradient L2 {dg:.2e} (own "
                      f"{og:.2e}), 1 - cos {dcos:.2e} (own {ocos:.2e})", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    readings(PATHS)
    readings(["analysis_detector"], VOICE_VIEWS, " voice")
    with pinned_codecs("analysis_detector"):
        readings(["analysis_detector"], VOICE_VIEWS, " voice, codecs pinned")
