"""The port's multi-device paths (``aware_tpu_torch/parallel``, ``detect_global``,
``train_amortized_embedder(mesh=...)``) against the JAX package's, as
``tests/test_parallel.py`` holds those on the 8 fake CPU devices.

The port's side runs in one gloo world of 8 ranks on the CPU, spawned from
this module (``_rank``; every case of the module in one world), joined
through ``file://`` under a temporary directory and one torch thread a
rank.  The ranks import no ``jax`` and nothing of ``aware_tpu``: this
module imports them only inside the reference fixture, and each rank
reports what it imported.  The JAX side runs in the pytest process on
the fake devices of ``tests/conftest.py``, while the world runs; each
rank saves what it returns, and each case is its own test.

Tolerances: detection values 1e-4 absolute and 1e-3 relative, with equal
signs (``tests/test_parallel.py``'s); the sharded embed against the
port's unsharded ``embed_batch`` to 1e-5 (float32 sums of another batch
size), and against the JAX sharded embed at the outcome level of
``tests/test_torch_slice.py`` (best losses within 0.02, the same bits read
back); the sharded training against the unsharded port run as
``tests/test_torch_train.py`` holds a step (metrics 1e-4 relative, each
parameter's moves within 5 % of the rate on all but 1 % of its elements),
and against the JAX mesh history to 1e-4 relative, given the JAX draws
and the JAX package's initial embedder (the port draws its own from a
torch generator).
"""

import concurrent.futures
import os
import sys

import numpy as np
import pytest
import torch

WORLD = 8
SR = 16000
ITERS = 12
LENGTHS = (32000, 31871, 160000)
SECONDS_40 = 20  # tiles of the 2 s clip: 40 s
# a non-default architecture through the sequence-parallel forward
ARCH = dict(activation="swish", norm_layer="none", final_activation="tanh",
            n_filters=(256, 512, 512), seed=3)
# the JAX mesh of the training reference: the first 4 fake devices
TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS, TRAIN_DEVICES = 4, 8000, 2, 4
TRAIN_FLAGS = dict(train_detector=True, detector_lr=1e-4)
VALUE_ATOL, VALUE_RTOL = 1e-4, 1e-3
METRIC_TOL = 1e-4


def _detect_clips(speechlike):
    return np.stack([np.roll(speechlike, 137 * i) for i in range(8)]).astype(np.float32)


def _embed_clips(speechlike):
    audios = np.stack([np.roll(speechlike, 311 * i) for i in range(8)]).astype(np.float32)
    wms = np.stack([(np.arange(20) % 2 == (i % 2)).astype(np.float32) * 2 - 1
                    for i in range(8)])
    return audios, wms


def _stream(speechlike, length):
    reps = int(np.ceil(length / len(speechlike)))
    return np.tile(speechlike, reps)[:length].astype(np.float32)


def _sampler():
    """The training clips, as tests/test_train.py's ``_sampler(batch, 8000)``."""
    from aware_tpu_torch.eval.harness import synthesize_speech_clip

    clips = np.stack([synthesize_speech_clip(s, seconds=TRAIN_LEN / SR)
                      for s in range(TRAIN_BATCH)])
    return lambda step: np.roll(clips, step * 17, axis=1)


def _train_configs():
    from aware_tpu_torch.config import AwareConfig
    from aware_tpu_torch.train import adversarial as adv

    tcfg = adv.TrainConfig(batch_size=TRAIN_BATCH, steps=TRAIN_STEPS,
                           embedder=adv.AmortizedEmbedderConfig(hidden=(32,)), **TRAIN_FLAGS)
    return AwareConfig(), tcfg


def _train(d_params, draws, **kwargs):
    """Two steps of the port's training loop, each clip's attack given in
    ``draws`` (the JAX draws, in the loop's order); ``init_e_params``
    carries the JAX package's initial embedder across (the port draws its
    own from a torch generator)."""
    from aware_tpu_torch.train import adversarial as adv

    cfg, tcfg = _train_configs()
    it = iter(draws)
    real = adv.draw_attack
    adv.draw_attack = lambda gen, attacks, length: next(it)
    try:
        state, hist = adv.train_amortized_embedder(cfg, tcfg, d_params, _sampler(), seed=0,
                                                   **kwargs)
    finally:
        adv.draw_attack = real
    return {"e": state.e_params, "d": state.d_params, "history": hist}


def _cases(rank, inputs, tmp):
    import aware_tpu_torch
    from aware_tpu_torch.config import AwareConfig, DetectorNetConfig
    from aware_tpu_torch.models.detector import DetectorNet, init_params, params_from_jax
    from aware_tpu_torch.parallel import (
        get_mesh,
        sharded_detect_batch,
        sharded_embed_batch,
        streaming_detect_values,
    )
    from aware_tpu_torch.service.streaming import StreamingDetector

    speechlike = inputs["speechlike"]
    out = {}
    _, det = aware_tpu_torch.load(device="cpu")
    net = det.net
    data = get_mesh(("data",), device="cpu")
    out["data_shape"], out["data_index"] = dict(data.shape), data.index("data")
    try:
        get_mesh(("data", "seq"), shape=(2, 2), device="cpu")
    except ValueError as err:
        out["bad_shape"] = str(err)

    out["detect"] = sharded_detect_batch(net, _detect_clips(speechlike), AwareConfig(), data)
    audios, wms = _embed_clips(speechlike)
    cfg = AwareConfig(num_iterations=ITERS, use_pallas_roundtrip=False)
    out["embed"] = sharded_embed_batch(net, audios, wms, cfg, data)._asdict()
    try:
        sharded_embed_batch(net, audios[:3], wms[:3], cfg.replace(num_iterations=2), data)
    except ValueError as err:
        out["refusal"] = str(err)

    seq = get_mesh(("seq",), device="cpu")
    out["seq_shape"] = dict(seq.shape)
    for length in LENGTHS:
        out[f"stream_{length}"] = streaming_detect_values(
            net, _stream(speechlike, length), AwareConfig(), seq)
    out["stream_40s"] = streaming_detect_values(
        net, np.tile(speechlike, SECONDS_40), AwareConfig(), seq)
    arch = DetectorNetConfig(**ARCH)
    arch_net = DetectorNet(params_from_jax(init_params(arch)), arch)
    out["stream_arch"] = streaming_detect_values(
        arch_net, speechlike, AwareConfig(detection_net=arch), seq)

    two = get_mesh(("data", "seq"), shape=(2, 4), device="cpu")
    out["two_index"] = (two.index("data"), two.index("seq"))
    audio = speechlike if two.index("data") == 0 else np.roll(speechlike, 97)
    out["two_axis"] = streaming_detect_values(net, audio, AwareConfig(), two, axis="seq")

    # training with the batch over the (2, 4) mesh's data axis: 2 clips a
    # rank, the seq ranks replicas
    ckpt = os.path.join(tmp, f"ckpt_rank{rank}")
    out["train"] = _train({k: v for k, v in net.named_buffers() if k.startswith("conv")},
                          inputs["draws"], mesh=two, checkpoint_dir=ckpt,
                          init_e_params=inputs["e_params"])
    out["ckpt_written"] = os.path.isdir(ckpt)
    try:
        _train({}, [], mesh=object())
    except TypeError as err:
        out["train_not_mesh"] = str(err)
    # detect_global of the JAX sharded embed's first clip as a 44.1 kHz
    # stereo file (the mono mix and the resample to the model's rate
    # first), which the pytest process writes once it has it
    stereo = _wait_for(f"{tmp}/global_input.npy")
    out["global_bits"] = StreamingDetector(det, mesh=seq, threshold=0.1).detect_global(
        stereo, 44100)
    out["imported"] = sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "aware_tpu"))
    return out


def _wait_for(path, timeout=600.0):
    import time

    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.05)
    return np.load(path)


def _global_input(clip):
    """The 44.1 kHz stereo file of detect_global's case, from a 16 kHz
    clip: the port's resample, written where the ranks wait for it."""
    from aware_tpu_torch.ops.resample import resample

    up = resample(torch.as_tensor(np.asarray(clip, np.float32)), SR, 44100).numpy()
    return np.stack([up, 0.5 * up], axis=1).astype(np.float32)


def _rank(rank, world, tmp):
    import torch.distributed as dist

    torch.set_num_threads(1)
    # the inputs from a file: a spawned child reads its arguments only once
    # it has imported torch, and arguments past the pipe's buffer would
    # hold the parent's start of the next rank until then
    inputs = torch.load(f"{tmp}/inputs.pt", weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", world_size=world,
                            rank=rank)
    try:
        torch.save(_cases(rank, inputs, tmp), f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _jax_train_inputs():
    """The JAX training loop's draws of every clip's attack, step by step
    (``key, sub = split(key)`` a step, then the train step's split), and
    its initial embedder."""
    import jax

    from aware_tpu.config import AwareConfig as JaxConfig
    from aware_tpu.models import init_params
    from aware_tpu.train import adversarial as jadv
    from aware_tpu_torch.train import adversarial as adv
    from tests.test_torch_train import _jax_draws

    length = (TRAIN_LEN // 256) * 256
    attacks, _ = adv.make_attack_list(length)
    key, draws = jax.random.PRNGKey(0), []
    for _ in range(TRAIN_STEPS):
        key, sub = jax.random.split(key)
        draws += _jax_draws(sub, TRAIN_BATCH, attacks, length)
    state = jadv.init_train_state(JaxConfig(), _jax_train_config(),
                                  init_params(JaxConfig().detection_net))
    return draws, {k: np.asarray(v) for k, v in state.e_params.items()}


def _jax_train_config():
    from aware_tpu.train import adversarial as jadv

    return jadv.TrainConfig(batch_size=TRAIN_BATCH, steps=TRAIN_STEPS,
                            embedder=jadv.AmortizedEmbedderConfig(hidden=(32,)), **TRAIN_FLAGS)


def _references(speechlike, draws, e_params, tmp):
    """The JAX package's results on the fake devices, and the port's
    unsharded ones; the input of detect_global's case, written for the
    ranks as soon as it is made."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from aware_tpu import load as jax_load
    from aware_tpu.config import AwareConfig as JaxConfig
    from aware_tpu.config import DetectorNetConfig as JaxNetConfig
    from aware_tpu.models import init_params
    from aware_tpu.models.detector import detect_values_batch_jit, detect_values_jit
    from aware_tpu.parallel import get_mesh
    from aware_tpu.parallel import sharded_detect_batch as j_detect
    from aware_tpu.ops.resample import resample as jresample
    from aware_tpu.parallel import sharded_embed_batch as j_embed
    from aware_tpu.parallel import streaming_detect_values as j_stream
    from aware_tpu.service.streaming import StreamingDetector as JaxStreamingDetector
    from aware_tpu.train import adversarial as jadv
    import aware_tpu_torch
    from aware_tpu_torch.config import AwareConfig
    from aware_tpu_torch.embed.solver import embed_batch
    from aware_tpu_torch.models.detector import detect_values_batch

    params = init_params(JaxConfig().detection_net)
    cfg = JaxConfig()
    ref = {}
    data, seq = get_mesh(("data",)), get_mesh(("seq",))
    # the JAX training loop (its compile the longest of these) on a thread
    # of its own: JAX releases the GIL while it compiles and runs
    pool = concurrent.futures.ThreadPoolExecutor(1)
    train_mesh = get_mesh(("data",), devices=jax.devices()[:TRAIN_DEVICES])
    train = pool.submit(jadv.train_amortized_embedder, cfg, _jax_train_config(), params,
                        _sampler(), seed=0, mesh=train_mesh, init_e_params=e_params)
    ref["detect"] = np.asarray(j_detect(params, _detect_clips(speechlike), cfg, data))
    audios, wms = _embed_clips(speechlike)
    res = j_embed(params, audios, wms, cfg.replace(num_iterations=ITERS), data)
    ref["embed_best_loss"] = np.asarray(res.best_loss)
    ref["embed_values"] = np.asarray(detect_values_batch_jit(params, res.audio))
    stereo = _global_input(np.asarray(res.audio)[0])
    np.save(f"{tmp}/global_tmp.npy", stereo)
    os.replace(f"{tmp}/global_tmp.npy", f"{tmp}/global_input.npy")
    jmesh = Mesh(np.array(jax.devices()[:8]), ("seq",))
    _, jdet = jax_load()
    ref["global_bits"] = JaxStreamingDetector(jdet, mesh=jmesh, threshold=0.1).detect_global(
        stereo, 44100)
    mono = np.asarray(jresample(stereo.mean(axis=1), 44100, SR))
    ref["global_single"] = np.asarray(detect_values_jit(params, jnp.asarray(mono)))
    ref["global_pattern"] = wms[0] > 0
    for length in LENGTHS:
        audio = _stream(speechlike, length)
        ref[f"stream_{length}"] = np.asarray(j_stream(params, audio, cfg, seq))
        ref[f"single_{length}"] = np.asarray(detect_values_jit(params, jnp.asarray(audio)))
    arch = JaxNetConfig(**ARCH)
    arch_params = init_params(arch)
    ref["stream_arch"] = np.asarray(j_stream(arch_params, speechlike,
                                             cfg.replace(detection_net=arch), seq))
    ref["single_arch"] = np.asarray(detect_values_jit(arch_params, jnp.asarray(speechlike), arch))
    two = get_mesh(("data", "seq"), shape=(2, 4))
    ref["two_axis"] = [np.asarray(j_stream(params, a, cfg, two, axis="seq"))
                       for a in (speechlike, np.roll(speechlike, 97))]

    # the port, unsharded
    _, det = aware_tpu_torch.load(device="cpu")
    ref["port_detect"] = detect_values_batch(det.net, torch.from_numpy(_detect_clips(speechlike)))
    ref["port_embed"] = embed_batch(det.net, torch.from_numpy(audios), torch.from_numpy(wms),
                                    AwareConfig(num_iterations=ITERS, use_pallas_roundtrip=False))
    d_params = {k: v for k, v in det.net.named_buffers() if k.startswith("conv")}
    ref["port_train"] = _train(d_params, draws, device="cpu", init_e_params=e_params)
    _, ref["train_history"] = train.result()
    pool.shutdown()
    return ref


@pytest.fixture(scope="module")
def world(speechlike, tmp_path_factory):
    """(per-rank results, references): the world runs while the pytest
    process computes the references."""
    import torch.multiprocessing as mp

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = str(tmp_path_factory.mktemp("world"))
    draws, e_params = _jax_train_inputs()
    torch.save({"speechlike": speechlike, "draws": draws, "e_params": e_params},
               f"{tmp}/inputs.pt")
    ctx = mp.start_processes(_rank, args=(WORLD, tmp), nprocs=WORLD, join=False,
                             start_method="spawn")
    try:
        ref = _references(speechlike, draws, e_params, tmp)
    except BaseException:
        # the ranks may wait for detect_global's input: end them
        for proc in ctx.processes:
            proc.kill()
            proc.join()
        raise
    finally:
        torch.set_num_threads(n)
    while not ctx.join():
        pass
    ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(WORLD)]
    ref["e_params"] = e_params
    return ranks, ref


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, atol=VALUE_ATOL, rtol=VALUE_RTOL)
    np.testing.assert_array_equal(got > 0, want > 0)


def test_ranks_import_no_jax(world):
    ranks, _ = world
    for r in ranks:
        assert r["imported"] == []


def test_mesh_has_8_devices(world):
    ranks, _ = world
    assert [r["data_shape"] for r in ranks] == [{"data": 8}] * WORLD
    assert [r["data_index"] for r in ranks] == list(range(WORLD))
    assert [r["seq_shape"] for r in ranks] == [{"seq": 8}] * WORLD
    assert all("mesh shape (2, 2) != 8 devices" == r["bad_shape"] for r in ranks)
    assert [r["two_index"] for r in ranks] == [(i // 4, i % 4) for i in range(WORLD)]


def test_sharded_detect_matches_jax_and_local(world):
    ranks, ref = world
    for r in ranks:  # every rank returns the whole batch
        np.testing.assert_array_equal(_np(r["detect"]), _np(ranks[0]["detect"]))
    out = ranks[0]["detect"]
    assert out.shape == (8, 20)
    _close(out, ref["detect"])
    _close(out, ref["port_detect"])


def test_sharded_embed_matches_the_unsharded_embed(world):
    ranks, ref = world
    ours, local = ranks[0]["embed"], ref["port_embed"]._asdict()
    for r in ranks:
        for k in ours:
            np.testing.assert_array_equal(_np(r["embed"][k]), _np(ours[k]))
    assert ours["audio"].shape == (8, 32000)
    for k in ("audio", "best_loss", "final_loss", "coeffs"):
        np.testing.assert_allclose(_np(ours[k]), _np(local[k]), atol=1e-5, rtol=1e-5, err_msg=k)
    assert np.all(_np(ours["best_loss"]) <= _np(ours["final_loss"]) + 1e-6)


def test_sharded_embed_matches_jax_at_outcome_level(world):
    ranks, ref = world
    ours = ranks[0]["embed"]
    np.testing.assert_array_less(np.abs(_np(ours["best_loss"]) - ref["embed_best_loss"]), 0.02)
    from aware_tpu_torch.models.detector import detect_values_batch
    import aware_tpu_torch

    _, det = aware_tpu_torch.load(device="cpu")
    got = detect_values_batch(det.net, ours["audio"]).numpy() > 0
    np.testing.assert_array_equal(got, ref["embed_values"] > 0)


def test_sharded_embed_batch_size_validation(world):
    ranks, _ = world
    for r in ranks:
        assert "divisible" in r["refusal"] and "'data' size 8" in r["refusal"]


@pytest.mark.parametrize("length", LENGTHS)
def test_streaming_detect_matches_jax_and_single_device(world, length):
    ranks, ref = world
    for r in ranks:
        np.testing.assert_array_equal(_np(r[f"stream_{length}"]), _np(ranks[0][f"stream_{length}"]))
    ours = ranks[0][f"stream_{length}"]
    _close(ours, ref[f"stream_{length}"])
    _close(ours, ref[f"single_{length}"])


def test_streaming_detect_long_form(world, speechlike):
    ranks, _ = world
    from aware_tpu_torch.models.detector import detect_values
    import aware_tpu_torch

    out = ranks[0]["stream_40s"]
    assert out.shape == (20,) and torch.isfinite(out).all()
    _, det = aware_tpu_torch.load(device="cpu")
    _close(out, detect_values(det.net, torch.from_numpy(np.tile(speechlike, SECONDS_40))))


def test_streaming_detect_non_default_architecture(world):
    ranks, ref = world
    ours = ranks[0]["stream_arch"]
    _close(ours, ref["stream_arch"])
    _close(ours, ref["single_arch"])


def test_two_axis_mesh(world):
    """(data=2, seq=4): each data row detects its own clip, its sums over
    its seq ranks alone."""
    ranks, ref = world
    for rank, r in enumerate(ranks):
        _close(r["two_axis"], ref["two_axis"][rank // 4])
    assert not np.allclose(_np(ranks[0]["two_axis"]), _np(ranks[4]["two_axis"]))


def test_detect_global_matches_jax(world):
    """As tests/test_streaming_service.py's mesh-global case: the bits
    equal the JAX package's detect_global of the same file, the signs of a
    single-device detection of the mixed and resampled file, and the
    pattern embedded."""
    ranks, ref = world
    for r in ranks:
        np.testing.assert_array_equal(np.asarray(r["global_bits"]).astype(int),
                                      np.asarray(ref["global_bits"]).astype(int))
    np.testing.assert_array_equal(np.asarray(ref["global_bits"]).astype(int),
                                  (ref["global_single"] > 0).astype(int))
    np.testing.assert_array_equal(np.asarray(ref["global_bits"]).astype(bool),
                                  ref["global_pattern"])


def _moves_match(old, ours, want_old, want, lr):
    """tests/test_torch_train.py's criterion for one step's moves."""
    for k in ours:
        move, wmove = _np(ours[k] - old[k]), _np(want[k]) - _np(want_old[k])
        if k.startswith("conv") and k.endswith("_b"):
            assert np.abs(move).max() <= 2 * lr and np.abs(wmove).max() <= 2 * lr, k
            continue
        assert np.mean(np.abs(move - wmove) > 0.05 * lr) <= 0.01, k


def test_sharded_training_matches_the_unsharded_run(world):
    ranks, ref = world
    local = ref["port_train"]
    _, tcfg = _train_configs()
    d0 = _initial_detector()
    for r in ranks:
        ours = r["train"]
        assert len(ours["history"]) == TRAIN_STEPS
        for got, want in zip(ours["history"], local["history"]):
            for k in want:
                assert abs(got[k] - want[k]) <= METRIC_TOL * abs(want[k]) + 1e-6, k
        # every rank holds the same parameters
        for k in ours["e"]:
            np.testing.assert_array_equal(_np(ours["e"][k]), _np(ranks[0]["train"]["e"][k]))
    ours = ranks[0]["train"]
    e0 = {k: torch.from_numpy(v) for k, v in ref["e_params"].items()}
    _moves_match(e0, ours["e"], e0, local["e"], TRAIN_STEPS * tcfg.learning_rate)
    _moves_match(d0, ours["d"], d0, local["d"], TRAIN_STEPS * tcfg.detector_lr)
    # only rank 0 writes checkpoints; a mesh that is not a Mesh raises
    assert [r["ckpt_written"] for r in ranks] == [True] + [False] * (WORLD - 1)
    assert all("Mesh" in r["train_not_mesh"] for r in ranks)


def test_sharded_training_history_matches_jax(world):
    ranks, ref = world
    ours, want = ranks[0]["train"]["history"], ref["train_history"]
    assert len(ours) == len(want) == TRAIN_STEPS
    for step in range(TRAIN_STEPS):
        for k in want[step]:
            assert abs(ours[step][k] - want[step][k]) <= METRIC_TOL * abs(want[step][k]) + 1e-6, \
                (step, k)


def _initial_detector():
    from aware_tpu_torch.models.detector import load_key_params

    return {k: torch.from_numpy(v) for k, v in load_key_params().items()}


def test_a_world_of_one_and_the_refusals(speechlike):
    """With no process group and no launcher, ``get_mesh`` makes a world
    of one (gloo on the CPU) whose paths equal the single-device ones; a
    mesh on a card raises where there is none, and a shape that is not the
    world's size raises ValueError."""
    import torch.distributed as dist

    import aware_tpu_torch
    from aware_tpu_torch.config import AwareConfig
    from aware_tpu_torch.models.detector import detect_values
    from aware_tpu_torch.parallel import get_mesh, sharded_detect_batch, streaming_detect_values

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            get_mesh(("data",))
    assert not dist.is_initialized()
    try:
        mesh = get_mesh(("data",), device="cpu")
        assert mesh.shape == {"data": 1} and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match=r"mesh shape \(2,\) != 1 devices"):
            get_mesh(("seq",), shape=(2,), device="cpu")
        _, det = aware_tpu_torch.load(device="cpu")
        audio = _stream(speechlike, 31871)
        one = detect_values(det.net, torch.from_numpy(audio))
        _close(streaming_detect_values(det.net, audio, AwareConfig(), get_mesh(("seq",),
                                                                              device="cpu")), one)
        _close(sharded_detect_batch(det.net, audio[None], AwareConfig(), mesh)[0], one)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
