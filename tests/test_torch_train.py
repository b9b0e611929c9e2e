"""Adversarial training of the amortized embedder (``train/adversarial.py``'s
second half) against the JAX package on the CPU.

* Each differentiable attack given the values JAX drew from its key (the
  noise attack's SNR and noise both from the one key, as JAX draws them),
  to 1e-6; the quantizer's straight-through gradient; ``make_attack_list``'s
  branch count and common length with the desync and compression branches.
* ``_clip_loss``'s four metrics and the loss's gradient w.r.t. the
  embedder (and the detector) against ``jax.grad`` of the JAX package's,
  with the same attacks: float32 on both sides through an ISTFT, a random
  attack, an STFT and the detector's normalizations, so the metrics are
  held to 1e-4 relative and the gradients to 1e-3 in relative L2 (2e-2
  where a clip draws a vocoder stretch: its phase accumulation carries
  float32 rounding into every later frame, which is why the EOT views'
  tests hold the vocoder in float64).
* The optimizer against optax's ``apply_if_finite(chain(
  clip_by_global_norm(1), adamw))`` (and ``multi_transform`` with the
  detector's rate) on the same gradients, over steps with and without
  clipping: 1e-6 relative; a non-finite gradient leaves the parameters and
  the moments as they were, and after ``max_consecutive_errors`` in a
  row the update goes through, as optax's.
* One train step against the JAX package's train step with the same
  draws (embedder-only, joint with ``detector_lr``, ``dual_view``, the
  margin loss): the metrics to 1e-4 relative, and the parameters' moves
  to 5 % of the rate on all but 1 % of the elements of each leaf (Adam's
  first move is lr * g / (|g| + eps) per element, so an element whose
  gradient lies within the gradients' 1e-3 agreement of 0 can move by lr
  either way on either side); a NaN step skipped; the checkpoint round trip and the choice of
  the latest step; the training loop's patterns bit for bit.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from aware_tpu.config import AwareConfig as JaxConfig
from aware_tpu.models import init_params
from aware_tpu.train import adversarial as jadv
from aware_tpu_torch.config import AwareConfig
from aware_tpu_torch.train import adversarial as adv

SR = 16000
L = 6400  # 0.4 s clips: 26 frames
METRIC_TOL = 1e-4
GRAD_TOL = 1e-3
ECFG = dict(hidden=(32, 32))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def d_params():
    return {k: np.asarray(v) for k, v in init_params(JaxConfig().detection_net).items()}


def _clips(b: int, n: int = L, seed: int = 0) -> np.ndarray:
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    out = []
    for i in range(b):
        phase = np.cumsum(2 * np.pi * (110.0 + 40.0 * i + 20.0 * np.sin(2 * np.pi * 2 * t)) / SR)
        x = sum(np.cos(k * phase + rng.random()) / k for k in range(1, 20))
        x = x * (0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 2.5 * t))) + 0.02 * rng.standard_normal(n)
        out.append(x / np.max(np.abs(x)))
    return np.stack(out).astype(np.float32)


def _patterns(b: int, seed: int = 1) -> np.ndarray:
    return (np.random.default_rng(seed).integers(0, 2, (b, 20)) * 2 - 1).astype(np.float32)


def _jax_values(name: str, k_attack, length: int) -> tuple:
    """The values the JAX package's attack ``name`` draws from k_attack."""
    if name == "noise":
        snr = float(jax.random.uniform(k_attack, (), minval=20.0, maxval=40.0))
        return snr, torch.from_numpy(np.asarray(jax.random.normal(k_attack, (length,))))
    if name == "quantize":
        return (8.0 + 8.0 * float(jax.random.bernoulli(k_attack)),)
    if name == "lowpass":
        return (float(jax.random.uniform(k_attack, (), minval=3500.0, maxval=5000.0) / 16000.0),)
    if name == "dropout":
        return (int(jax.random.randint(k_attack, (), 0, length - length // 20)),)
    return ()


def _jax_draws(key, b: int, attacks: list, length: int) -> list:
    """The JAX train step's per-clip draws from ``key``: split over the
    batch, then (pick, attack) as ``apply_random_attack`` splits."""
    draws = []
    for k in jax.random.split(key, b):
        k_pick, k_attack = jax.random.split(k)
        idx = int(jax.random.randint(k_pick, (), 0, len(attacks)))
        draws.append((idx, _jax_values(attacks[idx].name, k_attack, length)))
    return draws


@pytest.mark.parametrize("i", range(5), ids=[a.name for a in adv.DIFFERENTIABLE_ATTACKS])
def test_each_attack_given_the_jax_draws(i):
    audio = _clips(1, 8000, seed=3)[0] * 0.7
    ours_attack, jax_attack = adv.DIFFERENTIABLE_ATTACKS[i], jadv.DIFFERENTIABLE_ATTACKS[i]
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jax_attack(jnp.asarray(audio), key))
        ours = ours_attack.apply(torch.from_numpy(audio),
                                 *_jax_values(ours_attack.name, key, len(audio)))
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=1e-5)
    # a draw from the port's generator has the application's arity
    ours_attack(torch.from_numpy(audio), torch.Generator().manual_seed(0))


@pytest.mark.parametrize("seed", [0, 1])
def test_quantizer_gradient_is_straight_through(seed):
    key = jax.random.PRNGKey(seed)
    x = torch.from_numpy(_clips(1, 800)[0] * 0.5).requires_grad_(True)
    bits = _jax_values("quantize", key, 800)
    (g,) = torch.autograd.grad((adv._apply_quantize(x, *bits) * torch.arange(800.0)).sum(), x)
    jg = jax.grad(lambda a: jnp.sum(jadv._attack_quantize(a, key) * jnp.arange(800.0)))(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("desync, compression", [(False, False), (True, False), (False, True),
                                                 (True, True)])
def test_attack_list_lengths(desync, compression):
    length = 31744
    ours, l_out = adv.make_attack_list(length, desync=desync, compression=compression)
    ref, ref_out = jadv.make_attack_list(length, desync=desync, compression=compression)
    assert (len(ours), l_out) == (len(ref), ref_out)
    x = torch.from_numpy(_clips(1, length, seed=5)[0])
    gen = torch.Generator().manual_seed(3)
    for a in ours:
        assert a(x, gen).shape == (l_out,)


def _jax_clip_loss(cfg, e_params, d_params, clips, pats, key, **kw):
    keys = jax.random.split(key, clips.shape[0])
    return jax.vmap(lambda a, p, k: jadv._clip_loss(cfg, e_params, d_params, a, p, k, **kw))(
        jnp.asarray(clips), jnp.asarray(pats), keys)


@pytest.mark.parametrize("kind", ["push_extremes", "margin_dual", "desync"])
def test_clip_loss_and_its_gradients_match_jax(d_params, kind):
    jcfg, cfg = JaxConfig(), AwareConfig()
    ecfg = jadv.AmortizedEmbedderConfig(**ECFG)
    je = jadv.init_embedder_params(ecfg, 225, 20)
    kw = {"margin_dual": dict(det_loss_kind="margin", margin_target=0.6, dual_view=True),
          "desync": dict(desync=True)}.get(kind, {})
    clips, pats = _clips(3), _patterns(3)
    key = jax.random.PRNGKey(7)

    def jax_loss(e, d):
        det, percept, soft, hard = _jax_clip_loss(jcfg, e, d, clips, pats, key, **kw)
        return jnp.mean(det) + jnp.mean(percept), (det, percept, soft, hard)

    (jl, jm), (jge, jgd) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))(
        je, {k: jnp.asarray(v) for k, v in d_params.items()})
    length = (L // 256) * 256
    attacks, _ = adv.make_attack_list(length, desync=kind == "desync")
    draws = _jax_draws(key, 3, attacks, length)
    e = {k: torch.from_numpy(np.asarray(v)).requires_grad_(True) for k, v in je.items()}
    d = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in d_params.items()}
    ours = adv._clip_loss(cfg, e, d, torch.from_numpy(clips), torch.from_numpy(pats), draws,
                          attacks, dual_view=kw.get("dual_view", False),
                          det_loss_kind=kw.get("det_loss_kind", "push_extremes"),
                          margin_target=kw.get("margin_target", 0.5))
    for got, ref in zip(ours, jm):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=METRIC_TOL,
                                   atol=1e-6)
    loss = ours[0].mean() + ours[1].mean()
    assert abs(float(loss) - float(jl)) <= METRIC_TOL * abs(float(jl))
    grads = torch.autograd.grad(loss, list(e.values()) + list(d.values()))
    refs = [np.asarray(jge[k]) for k in e] + [np.asarray(jgd[k]) for k in d]
    # the detector's conv biases feed an instance norm, which cancels them:
    # their gradient is rounding noise, held against the whole tree's scale
    scale = np.sqrt(sum(np.sum(r.astype(np.float64) ** 2) for r in refs))
    tol = GRAD_TOL if all(attacks[i].name[:4] != "time" for i, _ in draws) else 2e-2
    for name, g, r in zip(list(e) + list(d), grads, refs):
        assert np.linalg.norm(g.numpy() - r) <= tol * np.linalg.norm(r) + 1e-6 * scale, name


def _tree(rng, shapes, scale):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("joint", [False, True], ids=["embedder", "joint_detector_lr"])
def test_optimizer_matches_optax(joint):
    rng = np.random.default_rng(0)
    e_shapes, d_shapes = {"w0": (6, 5), "b0": (6,)}, {"conv0_w": (4, 3), "conv0_b": (4,)}
    e, d = _tree(rng, e_shapes, 1.0), _tree(rng, d_shapes, 1.0)
    tcfg = adv.TrainConfig(learning_rate=3e-3, train_detector=joint,
                           detector_lr=1e-3 if joint else None)
    jtcfg = jadv.TrainConfig(learning_rate=3e-3, train_detector=joint,
                             detector_lr=1e-3 if joint else None)
    tx = jadv._optimizer(jtcfg)
    jparams = (e, d) if joint else e
    jstate = tx.init(jparams)
    opt = adv._optimizer(tcfg)
    params = {"e": {k: torch.from_numpy(v.copy()) for k, v in e.items()}}
    if joint:
        params["d"] = {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    state = opt.init(params)
    # norms above and below the clip, and a non-finite step in the middle
    for scale in (3.0, 0.05, np.nan, 0.3, 10.0):
        ge, gd = _tree(rng, e_shapes, 1.0), _tree(rng, d_shapes, 1.0)
        ge, gd = ({k: v * scale for k, v in ge.items()}, {k: v * scale for k, v in gd.items()})
        jg = (ge, gd) if joint else ge
        upd, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        grads = {"e": {k: torch.from_numpy(v) for k, v in ge.items()}}
        if joint:
            grads["d"] = {k: torch.from_numpy(v) for k, v in gd.items()}
        state = opt.update(grads, state, params)
        ref = jparams if joint else (jparams,)
        for ours, want in zip(params.values(), ref):
            for k in ours:
                np.testing.assert_allclose(ours[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                           atol=1e-7)
        assert state["notfinite_count"] == int(jstate.notfinite_count)
        assert state["total_notfinite"] == int(jstate.total_notfinite)


def test_nonfinite_steps_give_up_after_max_consecutive_errors():
    tx = optax.apply_if_finite(optax.chain(optax.clip_by_global_norm(1.0),
                                           optax.adamw(1e-2, weight_decay=1e-5)), 2)
    opt = adv.AdamW({"e": (("e",), 1e-2, 1e-5)}, max_consecutive_errors=2)
    p = np.ones(3, np.float32)
    jp, jst = {"w": jnp.asarray(p)}, None
    jst = tx.init(jp)
    params = {"e": {"w": torch.from_numpy(p.copy())}}
    st = opt.init(params)
    for g in ([np.nan, 1, 1], [1, np.inf, 1], [np.nan, 0, 0], [0.5, 0.5, 0.5]):
        g = np.asarray(g, np.float32)
        upd, jst = tx.update({"w": jnp.asarray(g)}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        st = opt.update({"e": {"w": torch.from_numpy(g)}}, st, params)
        np.testing.assert_allclose(params["e"]["w"].numpy(), np.asarray(jp["w"]), rtol=1e-6)
        assert st["notfinite_count"] == int(jst.notfinite_count)
    assert not np.isfinite(params["e"]["w"].numpy()).all()  # the third NaN went through


def _both_states(cfg, jcfg, tcfg, jtcfg, d_params):
    jstate = jadv.init_train_state(jcfg, jtcfg, d_params)
    state = adv.init_train_state(cfg, tcfg, d_params, device="cpu")
    state = state._replace(e_params=adv._as_params({k: np.asarray(v) for k, v in
                                                    jstate.e_params.items()}, "cpu"))
    return state._replace(opt_state=adv._optimizer(tcfg).init(adv._trainable(state, tcfg))), jstate


@pytest.mark.parametrize("flags", [
    {},
    {"train_detector": True, "detector_lr": 1e-4},
    {"dual_view": True},
    {"det_loss": "margin", "margin_target": 0.6},
], ids=["embedder", "joint", "dual_view", "margin"])
def test_one_train_step_matches_jax(d_params, flags):
    cfg, jcfg = AwareConfig(), JaxConfig()
    tcfg = adv.TrainConfig(embedder=adv.AmortizedEmbedderConfig(**ECFG), **flags)
    jtcfg = jadv.TrainConfig(embedder=jadv.AmortizedEmbedderConfig(**ECFG), **flags)
    state, jstate = _both_states(cfg, jcfg, tcfg, jtcfg, d_params)
    clips, pats = _clips(2, seed=4), _patterns(2, seed=5)
    key = jax.random.PRNGKey(3)
    jnew, jm = jax.jit(jadv.make_train_step(jcfg, jtcfg))(jstate, jnp.asarray(clips),
                                                          jnp.asarray(pats), key)
    length = (L // 256) * 256
    attacks, _ = adv.make_attack_list(length)
    new, m = adv.make_train_step(cfg, tcfg)(state, clips, pats,
                                            draws=_jax_draws(key, 2, attacks, length))
    assert new.step == 1 and int(jnew.step) == 1
    for k in m:
        assert abs(float(m[k]) - float(jm[k])) <= METRIC_TOL * abs(float(jm[k])) + 1e-6, k
    pairs = [(state.e_params, new.e_params, jstate.e_params, jnew.e_params)]
    if flags.get("train_detector"):
        pairs.append((state.d_params, new.d_params, jstate.d_params, jnew.d_params))
    else:
        assert all(new.d_params[k] is state.d_params[k] for k in state.d_params)
    for (old, ours, jold, ref), lr in zip(pairs, (tcfg.learning_rate, tcfg.detector_lr)):
        for k in ours:
            move, want = (ours[k] - old[k]).numpy(), np.asarray(ref[k]) - np.asarray(jold[k])
            if k.startswith("conv") and k.endswith("_b"):
                # an instance norm cancels the detector's conv biases: their
                # gradient is rounding noise on both sides, and only the
                # bound of one Adam step holds
                assert np.abs(move).max() <= lr and np.abs(want).max() <= lr, k
                continue
            assert np.abs(want).max() > 0.5 * lr, k  # every other leaf moved
            assert np.mean(np.abs(move - want) > 0.05 * lr) <= 0.01, k


def test_a_nan_step_is_skipped_and_counted(d_params):
    cfg = AwareConfig()
    tcfg = adv.TrainConfig(embedder=adv.AmortizedEmbedderConfig(**ECFG))
    state = adv.init_train_state(cfg, tcfg, d_params, device="cpu")
    clips = _clips(2)
    clips[1, 100] = np.nan
    new, m = adv.make_train_step(cfg, tcfg)(state, clips, _patterns(2),
                                            torch.Generator().manual_seed(0))
    assert not np.isfinite(float(m["loss"]))
    assert all(torch.equal(new.e_params[k], state.e_params[k]) for k in state.e_params)
    assert new.opt_state["notfinite_count"] == 1 and new.opt_state["groups"]["e"]["count"] == 0
    assert new.step == 1


def test_checkpoint_round_trip_and_the_latest_step(d_params, tmp_path):
    cfg = AwareConfig()
    tcfg = adv.TrainConfig(embedder=adv.AmortizedEmbedderConfig(**ECFG), train_detector=True,
                           detector_lr=1e-4)
    state = adv.init_train_state(cfg, tcfg, d_params, device="cpu")
    step = adv.make_train_step(cfg, tcfg)
    gen = torch.Generator().manual_seed(1)
    s1, _ = step(state, _clips(2), _patterns(2), gen)
    adv.save_checkpoint(tmp_path, s1)
    s2, _ = step(s1, _clips(2, seed=2), _patterns(2, seed=3), gen)
    adv.save_checkpoint(tmp_path, s2._replace(step=10))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_1", "step_10"]
    latest = adv.restore_checkpoint(tmp_path, device="cpu")
    assert latest.step == 10
    first = adv.restore_checkpoint(tmp_path, step=1, device="cpu")
    for got, want in ((first, s1), (latest, s2)):
        for a, b in ((got.e_params, want.e_params), (got.d_params, want.d_params)):
            assert all(torch.equal(a[k], b[k]) for k in b)
        for g in ("e", "d"):
            gs, ws = got.opt_state["groups"][g], want.opt_state["groups"][g]
            assert gs["count"] == ws["count"]
            for n in ws["mu"]:
                assert all(torch.equal(gs["mu"][n][k], ws["mu"][n][k]) for k in ws["mu"][n])
    # a step from the restored state is the step from the saved one
    a, _ = step(first, _clips(2, seed=2), _patterns(2, seed=3), torch.Generator().manual_seed(9))
    b, _ = step(s1, _clips(2, seed=2), _patterns(2, seed=3), torch.Generator().manual_seed(9))
    assert all(torch.equal(a.e_params[k], b.e_params[k]) for k in a.e_params)
    with pytest.raises(FileNotFoundError):
        adv.restore_checkpoint(tmp_path / "none", device="cpu")


def test_training_loop_patterns_checkpoints_and_mesh(d_params, tmp_path, monkeypatch):
    cfg = AwareConfig()
    tcfg = adv.TrainConfig(embedder=adv.AmortizedEmbedderConfig(**ECFG), steps=3)
    seen = []
    real = adv.make_train_step

    def spy(cfg_, tcfg_, group=None):
        step = real(cfg_, tcfg_, group)

        def wrapped(state, audios, patterns, gen=None, draws=None):
            seen.append(np.asarray(patterns))
            return step(state, audios, patterns, gen, draws)
        return wrapped

    monkeypatch.setattr(adv, "make_train_step", spy)
    state, hist = adv.train_amortized_embedder(cfg, tcfg, d_params, lambda i: _clips(2, seed=i),
                                               seed=5, checkpoint_dir=str(tmp_path),
                                               checkpoint_every=2, device="cpu")
    rng = np.random.default_rng(5)  # the JAX loop's patterns, bit for bit
    for got in seen:
        np.testing.assert_array_equal(got, rng.integers(0, 2, (2, 20)) * 2 - 1)
    assert len(hist) == 3 and state.step == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_3"]
    # a mesh that is not the port's Mesh (tests/test_torch_parallel.py
    # holds the data-parallel loop)
    with pytest.raises(TypeError, match="Mesh"):
        adv.train_amortized_embedder(cfg, tcfg, d_params, lambda i: _clips(2), mesh=object(),
                                     device="cpu")
    out = adv.amortized_embed(state, d_params, _clips(1)[0], _patterns(1)[0], cfg, device="cpu")
    ref = np.asarray(jadv.amortized_embed({k: jnp.asarray(v.numpy()) for k, v in
                                           state.e_params.items()}, None, _clips(1)[0],
                                          _patterns(1)[0], JaxConfig()))
    np.testing.assert_allclose(out, ref, atol=2e-5)
