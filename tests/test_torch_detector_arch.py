"""Every detector architecture of the JAX package's schema in the port.

* The fresh init (``init_params`` of a configuration other than the
  default card's): the port's numpy threefry2x32, ``split`` and
  ``uniform`` against ``aware_tpu.models.init_params`` bit for bit, on
  other widths, other block counts, another seed and another kernel
  size; the golden key and a key bundle as they are.
* The forward and the masked forward against ``detector_apply`` and
  ``detector_apply_masked`` for each block activation (an unknown name is
  relu) x norm x readout: 1e-4 relative with a 2e-5 absolute floor, as
  ``tests/test_torch_detector.py`` holds the default net; an invalid norm
  or readout raises in both packages.
* The solver's gate against ``fused_detector_supported`` field by field,
  and a non-default architecture's embed on the plain banded forward
  against the JAX embed at the outcome level of ``tests/test_torch_slice.py``
  (best losses within 0.02, the same bits read back).
* ``load()`` of a card file that names a non-default architecture.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aware_tpu_torch
from aware_tpu.config import AwareConfig as JaxConfig
from aware_tpu.config import DetectorNetConfig as JaxNetConfig
from aware_tpu.embed.solver import embed_batch as jax_embed_batch
from aware_tpu_torch.config import AwareConfig, DetectorNetConfig
from aware_tpu_torch.embed import solver
from aware_tpu_torch.models import detector as td
from aware_tpu_torch.ops.kernels import detector as tkd

jd = importlib.import_module("aware_tpu.models.detector")
jkd = importlib.import_module("aware_tpu.ops.pallas.detector")

RTOL, ATOL = 1e-4, 2e-5
# a narrow net, so that each forward is cheap
SMALL = dict(n_filters=(64, 96, 64))
BLOCK_ACTS = ["leaky_relu", "gelu", "swish", "relu", "elu"]  # elu: relu, silently
NORMS = ["instance", "none"]
READOUTS = ["relu", "leaky_relu", "gelu", "swish", "tanh", "sigmoid"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(**fields):
    return DetectorNetConfig(**fields), JaxNetConfig(**fields)


@pytest.mark.parametrize("fields", [
    dict(n_filters=(256, 512, 512)),
    dict(num_blocks=2, n_filters=(384, 256)),
    dict(seed=7),
    dict(kernel_size=3, n_mels=64, output_length=16, n_filters=(128, 128, 128), seed=-5),
    dict(activation="gelu", norm_layer="none", final_activation="sigmoid"),
    dict(),
    dict(key_file="desync_key_v1.npz"),
], ids=["widths", "blocks", "seed", "kernel-size", "activations", "golden-key", "key-file"])
def test_init_params_bit_for_bit(fields):
    ours, ref = _both(**fields)
    got, want = td.init_params(ours), jd.init_params(ref)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 328656719, 2**31 - 1])
def test_prng_key_and_split(seed):
    import jax

    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(td.prng_key(seed), np.asarray(key))
    np.testing.assert_array_equal(td.prng_split(td.prng_key(seed), 3),
                                  np.asarray(jax.random.split(key, 3)))


def _net_pair(**fields):
    ours, ref = _both(**SMALL, **fields)
    params = td.init_params(ours)
    return td.DetectorNet(td.params_from_jax(params), ours), params, ref


def _mag(t=40, seed=0):
    rng = np.random.default_rng(seed + t)
    return np.abs(rng.standard_normal((513, t))).astype(np.float32) * 3.0


@pytest.mark.parametrize("readout", READOUTS)
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("act", BLOCK_ACTS)
def test_forward_and_masked_forward_match_jax(act, norm, readout):
    net, params, ref_cfg = _net_pair(activation=act, norm_layer=norm, final_activation=readout)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    mag = _mag()
    ours = net(torch.from_numpy(mag)[None])[0].numpy()
    want = np.asarray(jd.detector_apply(jparams, jnp.asarray(mag), ref_cfg))
    np.testing.assert_allclose(ours, want, rtol=RTOL, atol=ATOL)
    # 33 valid frames of 40, the rest zero-padded
    mask = (np.arange(40) < 33).astype(np.float32)
    padded = mag * mask
    ours_m = net.forward_masked(torch.from_numpy(padded)[None], torch.from_numpy(mask)[None])
    want_m = np.asarray(jd.detector_apply_masked(jparams, jnp.asarray(padded),
                                                 jnp.asarray(mask), ref_cfg))
    np.testing.assert_allclose(ours_m[0].numpy(), want_m, rtol=RTOL, atol=ATOL)
    # and the masked forward is the forward of the valid frames
    np.testing.assert_allclose(
        ours_m[0].numpy(), net(torch.from_numpy(mag[:, :33])[None])[0].numpy(),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fields, match", [
    (dict(norm_layer="batch"), "Invalid norm layer"),
    (dict(final_activation="softmax"), "Invalid activation"),
])
def test_invalid_norm_and_readout_raise_as_in_jax(fields, match):
    net, params, ref_cfg = _net_pair(**fields)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    mag = _mag()
    with pytest.raises(ValueError, match=match):
        jd.detector_apply(jparams, jnp.asarray(mag), ref_cfg)
    with pytest.raises(ValueError, match=match):
        net(torch.from_numpy(mag)[None])
    with pytest.raises(ValueError, match=match):
        net.forward_masked(torch.from_numpy(mag)[None], torch.ones(1, mag.shape[1]))


@pytest.mark.parametrize("change", [
    {"norm_layer": "none"}, {"activation": "gelu"}, {"activation": "LEAKY_RELU"},
    {"activation": "relu"}, {"final_activation": "sigmoid"}, {"final_activation": "TANH"},
    {"kernel_size": 3}, {"seed": 1}, {"stride": 2}, {},
])
def test_gate_matches_jax_on_the_architecture_fields(change):
    ours = tkd.fused_detector_supported(DetectorNetConfig(**change), 225, 126, 1024)
    ref = jkd.fused_detector_supported(JaxNetConfig(**change), 225, 126, 1024)
    assert ours == ref


# the architecture of the embed and load() cases: other widths, gelu, no
# norm; tanh, so that the bits read back mean something
ARCH = dict(activation="gelu", norm_layer="none", final_activation="tanh",
            n_filters=(256, 512, 512), seed=11)
ITERS = 10


def test_non_default_architecture_embeds_on_the_plain_forward(speechlike):
    net_cfg, ref_cfg = _both(**ARCH)
    params = td.init_params(net_cfg)
    net = td.DetectorNet(td.params_from_jax(params), net_cfg)
    clips = np.stack([speechlike, np.roll(speechlike, 1234)])
    bits = np.random.default_rng(9).integers(0, 2, (2, 20))
    wm = (2.0 * bits - 1.0).astype(np.float32)
    x, w = torch.from_numpy(clips), torch.from_numpy(wm)
    # the default flags: the round-trip kernels, the gate off the detector
    # kernels, so the detector runs in plain torch
    pb = solver.build_problem(net, x, w, AwareConfig(detection_net=net_cfg))
    assert pb.path == "band_analysis" and pb.fused is None and pb.iteration is None
    # the float32 slab path on both sides (the JAX package's default flags)
    cfg = AwareConfig(detection_net=net_cfg, num_iterations=ITERS, use_pallas_roundtrip=False)
    ours = solver.embed_batch(net, x, w, cfg)
    jcfg = JaxConfig(detection_net=ref_cfg, num_iterations=ITERS)
    ref = jax_embed_batch({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(clips),
                          jnp.asarray(wm), jcfg)
    np.testing.assert_array_less(np.abs(ours.best_loss.numpy() - np.asarray(ref.best_loss)), 0.02)
    got = td.detect_values_batch(net, ours.audio).numpy() > 0
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    want = np.stack([np.asarray(jd.detect_values(jparams, a, ref_cfg)) for a in ref.audio]) > 0
    np.testing.assert_array_equal(got, want)


def test_load_a_card_with_a_non_default_architecture(tmp_path, speechlike):
    import yaml

    card = tmp_path / "arch.yaml"
    card.write_text(yaml.safe_dump({"detection_net_cfg": {
        **{k: v for k, v in ARCH.items() if k != "n_filters"},
        "n_filters": list(ARCH["n_filters"])}}))
    emb, det = aware_tpu_torch.load(card, device="cpu")
    ref = JaxConfig.from_card(card).detection_net
    for f in dataclasses.fields(ref):
        assert getattr(det.cfg.detection_net, f.name) == getattr(ref, f.name), f.name
    want = jd.init_params(ref)
    assert emb.net is det.net
    for k, v in want.items():
        np.testing.assert_array_equal(getattr(det.net, k).numpy(), v, err_msg=k)
    jparams = {k: jnp.asarray(v) for k, v in want.items()}
    values = td.detect_values(det.net, torch.from_numpy(speechlike)).numpy()
    np.testing.assert_allclose(values, np.asarray(jd.detect_values(jparams, speechlike, ref)),
                               rtol=RTOL, atol=ATOL)
