"""How closely the detector and whole-iteration kernels must agree with
their plain versions.

``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold the CUDA kernels of
``detector.py``, ``analysis_detector.py`` and ``iteration.py`` to these
bounds.  Run on a card, this module takes the readings the detector
bounds were set from:

    python3 -m aware_tpu_torch.ops.kernels.agreement [--seeds 8]

Why the bounds are not float32-tight: the detector is a chain of bf16
roundings.  The kernel and its plain version sum their float32 reductions
in other orders, so a value that lands within an ulp of a bf16 rounding
boundary now and then rounds the other way on one side.  Each such flip
moves one conv operand by 2^-8 of itself, and the instance norms over T2
frames carry it to every later layer; with few frames (T = 8: norms over 4
rows) one flip moves pred by several percent of max|pred|.  The readings
hold each comparison beside the plain version's own spread: the plain
version against itself with its input moved by 1e-6 of itself, which
flips roundings in the same way.

The forward is held on every output the backward reads, not on pred
alone: each to a bound on max |kernel - plain| / max |plain| (FWD_TOL), and
the bf16 residuals also to a share of elements more than one ulp apart
(SHARE_TOL).  The VJP kernel is held on the plain forward's residuals, and
the chain the solver runs (kernel forward, then the VJP kernel on its own
residuals) against the plain chain, by direction and by norm.  Each bound
is about twice the largest reading of the kernel or of the plain
version's own spread over eight seeds (PERF.md has the readings); below
32 frames the chain is held to twice the JAX kernels' own spread
(SHORT_CHAIN_TOL).

The whole-iteration kernels (``check_iteration``) run the same detector
chains behind the synthesis and a bf16 rounding of its output, which
widens their spread: they are held to bounds read the same way (ITER_*),
plus what no bf16 rounding sits in front of: y2 and m1 (Y2_TOL, float32
sums in another order) and the step's NAdam / clamp / best epilogue given
the same input (EPILOGUE_TOL: the same IEEE operations; the best snapshot
and best_loss exactly).
"""

from __future__ import annotations

import argparse
import math

import torch

SHORT_FRAMES = 32  # below it the norms see fewer than 16 frames
# Bounds per output of the forward, (from 32 frames, below 32 frames):
# max |kernel - plain| / max |plain| (gmu: absolute)
FWD_TOL = {
    "pred": (4e-2, 0.25),
    "mu1": (6e-4, 2.5e-3), "r1": (6e-4, 2.5e-3), "gr": (2e-5, 6e-5), "s": (2e-5, 6e-5),
    "gmu": (3e-7, 3e-7),
    **{f"rin{i}": (1e-2, 0.3) for i in range(4)},
    **{f"y{i}": (2e-2, 0.3) for i in range(4)},
    "mel": (2.0**-6, 2.0**-6),  # nph, a unit phase, is held by its share alone
}
# bf16 residuals: share of elements more than one ulp apart
SHARE_TOL = {"nph": 5e-3, "mel": 1e-3, **{f"y{i}": 0.4 for i in range(4)}}
# the VJP kernel from the plain forward's residuals: max error / max|plain|,
# 1 - cosine, |norm ratio - 1|
VJP_TOL = {"err": 1e-2, "1-cos": 1e-5, "norm": 5e-4}
# kernel forward then VJP kernel against the plain chain, from 32 frames
CHAIN_TOL = {"1-cos": 3e-2, "norm": 5e-3}
# the same below 32 frames: twice the JAX kernels' own chain spread at
# T = 8, 9 (moving their input by 1e-6 of itself turns their chain by up to
# 1 - cosine 1.23 and changes its norm by up to 51 %), so the direction
# bound is its whole range and only the norm binds; short clips are held at
# the outcome level on the card (chip_smoke.py's short-clip phase)
SHORT_CHAIN_TOL = {"1-cos": 2.0, "norm": 1.0}


# The whole-iteration kernels run the detector chains behind the
# synthesis, whose output y2 is rounded to bf16 before the analysis: each
# ulp of difference in y2 flips some of those roundings too, so their
# detector outputs spread wider than the detector kernels' own.  Bounds,
# about twice the larger reading of the kernel and of the plain version
# with ct moved by 1e-6 of itself, on speech-like problems
# (``iteration_problem``), eight seeds at T = 8, 9 and at T = 33, 97, 626
# (``--only iteration``; PERF.md has the readings):
ITER_FWD_TOL = {
    "pred": (5e-2, 0.3),
    "mu1": (6e-4, 1e-3), "r1": (1.6e-3, 7e-3), "gr": (3e-5, 1.6e-4), "s": (3e-5, 1.6e-4),
    "gmu": (3e-7, 3e-7),
    **{f"rin{i}": (2e-2, 0.35) for i in range(4)},
    **{f"y{i}": (4e-2, 0.3) for i in range(4)},
    "mel": (2.0**-6, 2.0**-6),
}
ITER_SHARE_TOL = {"nph": 0.15, "mel": 1.2e-2, **{f"y{i}": 0.55 for i in range(4)}}
# the chain (and the step's own gradient) from 32 frames; below it
# SHORT_CHAIN_TOL (the iteration chain turns by up to 1 - cosine 0.13)
ITER_CHAIN_TOL = {"1-cos": 0.2, "norm": 6e-2}
# the step's loss: max error / max|plain|, (from 32 frames, below 32 frames)
ITER_LOSS_TOL = (1e-3, 4e-3)
# the step's loss against push_extremes of the step's own pred: max error
# / max|plain| (a sum of 20 terms in another order)
STEP_LOSS_TOL = 1e-5
# q = sum gy2 y2 of the step's peak-norm VJP: error / sum |gy2 y2|
SCALAR_TOL = 1e-5
# y2 and m1 of the iteration forward, before any bf16 rounding: max error
# / max|plain| (float32 sums in another order; measured 1.3e-6)
Y2_TOL = 1e-5
# the step's epilogue given the same dreim: ct, m, v, max error / max|plain|
EPILOGUE_TOL = 1e-6


# Short clips (8 and 9 frames) on the card against the CPU plain solve, by
# outcome: a 400-iteration solve's BER on one lane is a draw there, for
# the reference too (moving its clips by 1e-6 of themselves reads a lane
# worse on 11 and 5 of 32 lanes), so no rule per lane separates a worse
# card from chance.  Over many lanes, a card as good as the reference
# makes "card worse" and "card better" equally likely on a lane where
# they differ: a one-sided sign test refuses the card when so many lanes
# read worse that chance would give as many less often than SHORT_ALPHA.
SHORT_ALPHA = 1e-3


def short_outcome(ber_card, ber_ref, alpha: float = SHORT_ALPHA) -> tuple:
    """The one-sided sign test of per-lane BERs, card against reference:
    (W, L, p, ok), W the lanes whose card BER is higher, L those whose
    card BER is lower (ties drop out), p = P(Binomial(W + L, 1/2) >= W)
    summed exactly, and ok = p >= alpha."""
    pairs = list(zip(ber_card, ber_ref, strict=True))
    worse = sum(float(k) > float(r) for k, r in pairs)
    better = sum(float(k) < float(r) for k, r in pairs)
    n = worse + better
    p = sum(math.comb(n, i) for i in range(worse, n + 1)) / 2**n
    return worse, better, p, p >= alpha


def lane_ber(net, audio: torch.Tensor, bits):
    """BER % per lane of embedded audio (B, L) against the bits (B, 20),
    read back by the plain detector ``net`` on the audio's device."""
    import numpy as np

    from aware_tpu_torch.models.detector import detect_values_batch

    return np.mean((detect_values_batch(net, audio).cpu().numpy() > 0) != bits, axis=1) * 100.0


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units of b's bf16 ulp (8 significant bits), elementwise."""
    a, b = a.double(), b.double()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(2.0**-126))) - 7)
    return (a - b).abs() / ulp


def forward_report(res_k, res_p) -> dict:
    """Per output of the detector forward (``DetResiduals``), how far the
    kernel's is from the plain version's: max |kernel - plain| / max |plain|
    (gmu, a mean of standardized values near 0: max |kernel - plain|), and
    for the bf16 residuals the share of elements more than one ulp apart."""
    out = {}
    for name, a, b in zip(res_p._fields, res_k, res_p):
        d = float((a.double() - b.double()).abs().max())
        out[name] = d if name == "gmu" else d / max(float(b.double().abs().max()), 1e-30)
        if b.dtype == torch.bfloat16:
            out[name + "_share"] = float((bf16_ulps(a, b) > 1).double().mean())
    return out


def check_forward(res_k, res_p, t: int, fwd_tol=FWD_TOL, share_tol=SHARE_TOL) -> dict:
    """Raise AssertionError where the kernel's forward (pred and every
    residual) departs from the plain one's by more than the bounds; return
    the report."""
    for name, a, b in zip(res_p._fields, res_k, res_p):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert bool(torch.isfinite(a.float()).all()), f"{name} is not finite"
    r = forward_report(res_k, res_p)
    short = int(t < SHORT_FRAMES)
    bad = [n for n, tol in fwd_tol.items() if not r[n] <= tol[short]]
    bad += [n + "_share" for n, tol in share_tol.items() if not r[n + "_share"] <= tol]
    assert not bad, f"forward departs from the plain version in {bad}: {fmt(r)}"
    return r


def vjp_report(out_k: torch.Tensor, out_p: torch.Tensor) -> dict:
    """How far one cotangent is from another: max error / max|plain|,
    1 - cosine and |norm ratio - 1|."""
    a, b = out_k.double().ravel(), out_p.double().ravel()
    return {
        "err": float((a - b).abs().max() / b.abs().max()),
        "1-cos": float(1 - a @ b / (a.norm() * b.norm())),
        "norm": float((a.norm() / b.norm() - 1).abs()),
    }


def check_vjp(out_k: torch.Tensor, out_p: torch.Tensor, chain: bool = False,
              t: int = SHORT_FRAMES, chain_tol=CHAIN_TOL) -> dict:
    """The VJP kernel against the plain VJP from the same residuals, or
    (``chain``) the kernel forward then backward against the plain chain
    on clips of ``t`` frames."""
    assert out_k.shape == out_p.shape, (out_k.shape, out_p.shape)
    assert bool(torch.isfinite(out_k).all()), "the cotangent is not finite"
    r = vjp_report(out_k, out_p)
    tols = VJP_TOL
    if chain:
        tols = SHORT_CHAIN_TOL if t < SHORT_FRAMES else chain_tol
    bad = [k for k, tol in tols.items() if not r[k] <= tol]
    assert not bad, f"{'chain' if chain else 'VJP'} departs from the plain one in {bad}: {fmt(r)}"
    return r


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


def check_iteration(ct, c, wm, g, k, t: int, seed: int = 0) -> dict:
    """The three whole-iteration kernels (ops/kernels/iteration.py) against
    their plain versions on ct (B, T, P), the constants c, the padded
    message wm (B, 128), a cotangent g (B, 128) and the NAdam constants k:

    * iteration_forward_fwd on pred and every residual (check_forward with
      ITER_FWD_TOL, ITER_SHARE_TOL), y2 and m1 to Y2_TOL;
    * iteration_forward_bwd from the plain residuals (VJP_TOL), and the
      chain from its own forward's (ITER_CHAIN_TOL, below 32 frames
      SHORT_CHAIN_TOL);
    * iteration_step at t = 1 (m = v = 0, lr 0.1): the loss to
      ITER_LOSS_TOL, its gradient (the phase fold of the dreim it leaves in
      its scratch) against the plain chain's as a chain; its loss and
      gradient against push_extremes of its own pred (STEP_LOSS_TOL) taken
      back through the VJP kernel on its own residuals (VJP_TOL), which
      holds its loss gradient and its chain tightly; the peak-norm VJP's
      per-clip scalars against the same reductions of its own gy2 and y2
      (exact, q to SCALAR_TOL); and its epilogue alone
      given one random dreim and state (``seed``) to EPILOGUE_TOL, best and
      best_loss exactly.

    Raises AssertionError on a departure; returns the readings, with the
    largest absolute error of each kernel's output under its name."""
    from aware_tpu_torch.embed.optim import nadam_schedule
    from aware_tpu_torch.ops.kernels import iteration as it
    from aware_tpu_torch.ops.kernels.roundtrip import peak_den, phase_fold_plain

    out: dict = {}
    _, res_k = it.iteration_forward_fwd(ct, c)
    _, res_p = it.iteration_forward_fwd_plain(ct, c)
    out["fwd"] = check_forward(res_k.det, res_p.det, t, ITER_FWD_TOL, ITER_SHARE_TOL)
    # the peak-normalized signal rows (not the detector's residual y2)
    out["signal"] = {"y2": _rel(res_k.y2, res_p.y2), "m1": _rel(res_k.m1, res_p.m1)}
    assert all(v <= Y2_TOL for v in out["signal"].values()), fmt(out["signal"])
    out["iteration_forward_fwd"] = float((res_k.det.pred - res_p.det.pred).abs().max())

    ref = it.iteration_forward_bwd_plain(g, res_p, c)
    vjp = it.iteration_forward_bwd(g, res_p, c)
    out["bwd"] = check_vjp(vjp, ref)
    out["bwd chain"] = check_vjp(it.iteration_forward_bwd(g, res_k, c), ref, chain=True, t=t,
                                 chain_tol=ITER_CHAIN_TOL)
    out["iteration_forward_bwd"] = float((vjp - ref).abs().max())

    b, _, p = ct.shape
    hop = c.env.shape[-1]
    lr = torch.full((b,), 0.1, device=ct.device)
    t1, _, mu_next, mu_prod = nadam_schedule(torch.zeros((), device=ct.device),
                                             torch.ones((), device=ct.device), 0.9, 4e-3)
    s1, s2 = lr, lr * mu_next / (1.0 - mu_prod * mu_next)  # at t = 1, mu_prod = mu_t
    d2 = (1.0 - 0.999**t1).reshape(1)

    def fresh():
        return [ct.clone(), torch.zeros_like(ct), torch.zeros_like(ct), ct.clone(),
                torch.full((b,), float("inf"), device=ct.device)]

    lower, upper = ct - ct.abs() / 2, ct + ct.abs() / 2
    state_k, state_p = fresh(), fresh()
    bufs = it.step_buffers(b, t, 2 * p, hop, ct.device) if ct.is_cuda else None
    loss_k = it.iteration_step(*state_k, lower, upper, wm, s1, s2, d2, c, k, bufs)
    loss_p = it.iteration_step_plain(*state_p, lower, upper, wm, s1, s2, d2, c, k)
    out["step loss"] = _rel(loss_k, loss_p)
    assert out["step loss"] <= ITER_LOSS_TOL[int(t < SHORT_FRAMES)], out["step loss"]
    out["iteration_step"] = float((loss_k - loss_p).abs().max())
    if bufs is not None:  # the gradient the kernel stepped with
        g_k = phase_fold_plain(bufs.scratch.big, c.csin)
        pred_p, res = it.iteration_forward_fwd_plain(ct, c)
        g_p = it.iteration_forward_bwd_plain(it.push_extremes_grad(pred_p, wm)[1], res, c)
        out["step gradient"] = check_vjp(g_k, g_p, chain=True, t=t, chain_tol=ITER_CHAIN_TOL)
        # and, tighter, against the plain loss and gradient of the step's
        # own pred, taken back through the VJP kernel on its own residuals
        loss_own, dpred_own = it.push_extremes_grad(bufs.res.det.pred, wm)
        out["step own loss"] = _rel(loss_k, loss_own)
        assert out["step own loss"] <= STEP_LOSS_TOL, out["step own loss"]
        out["step own gradient"] = check_vjp(
            g_k, it.iteration_forward_bwd(dpred_own, bufs.res, c))
        # the peak-norm VJP's per-clip scalars (cden, q (1+e) / cden, max |y2|,
        # ties) against the same reductions of the step's own folded gy2 and
        # y2: exact but for q, a sum in another order
        y2, gy2, scal = bufs.res.y2, bufs.scratch.gy2, bufs.scratch.scal
        mx = y2.abs().amax(dim=(1, 2))
        cden = peak_den(bufs.res.m1)[:, 0, 0]
        q = (gy2.double() * y2.double()).sum(dim=(1, 2)) * (1.0 + 1e-8) / cden.double()
        q_scale = (gy2.double() * y2.double()).abs().sum(dim=(1, 2)) / cden.double()
        out["step scalars"] = {"q": float(((scal[:, 1].double() - q).abs() / q_scale).max())}
        assert torch.equal(scal[:, 0], cden) and torch.equal(scal[:, 2], mx), "cden, max|y2|"
        assert torch.equal(scal[:, 3], (y2.abs() == mx[:, None, None]).sum(dim=(1, 2)).float()), \
            "ties"
        assert out["step scalars"]["q"] <= SCALAR_TOL, fmt(out["step scalars"])

    gen = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(ct.device)

    dreim = rand(b, t, 2 * p, scale=1e-2)
    loss = rand(b)
    best_loss = loss + torch.tensor([(-0.1) ** i for i in range(b)], device=ct.device)
    state = [ct, rand(b, t, p, scale=1e-3), rand(b, t, p, scale=1e-3).abs(),
             ct + rand(b, t, p), best_loss]
    state_k = [x.clone() for x in state]
    state_p = [x.clone() for x in state]
    args = (lower, upper, loss, s1 * rand(b).abs(), s2 * rand(b).abs(), d2)
    it._step_epilogue(dreim, c.csin, *state_k, *args, k)
    it.step_epilogue_plain(phase_fold_plain(dreim, c.csin), *state_p, *args, k)
    out["epilogue"] = {n: _rel(a, r) for n, a, r in zip(("ct", "m", "v"), state_k, state_p)}
    assert all(v <= EPILOGUE_TOL for v in out["epilogue"].values()), fmt(out["epilogue"])
    better = (loss < state[4])[:, None, None]
    assert torch.equal(state_k[3], torch.where(better, state_k[0], state[3])), "best"
    assert torch.equal(state_k[4], state_p[4]), "best_loss"
    return out


def fmt(report: dict) -> str:
    return ", ".join(f"{k} {v:.2e}" for k, v in report.items())


# --------------------------------------------------------------- readings ---

def _readings(seeds: int, frames: tuple[int, ...], batch: int, dev: torch.device) -> None:
    import numpy as np

    from aware_tpu_torch.config import DetectorNetConfig, in_band_bins
    from aware_tpu_torch.models.detector import load_key_params, params_from_jax
    from aware_tpu_torch.ops.kernels import analysis_detector as tad
    from aware_tpu_torch.ops.kernels import detector as td
    from aware_tpu_torch.ops.mel import mel_filter_bank

    hop = 256
    net = DetectorNetConfig()
    lo, hi = in_band_bins(net.sample_rate, net.n_fft, (500.0, 4000.0))
    basis = mel_filter_bank(net.sample_rate, net.n_fft, net.n_mels)
    csw = (np.random.default_rng(7).standard_normal((4 * hop, 2 * td.P_BAND)) / 16).astype(
        np.float32)
    params = params_from_jax(load_key_params())
    consts = {
        d: tad.AnalysisDetConsts(
            csw=torch.as_tensor(csw, device=d).to(torch.bfloat16),
            cswt=torch.as_tensor(csw.T.copy(), device=d).to(torch.bfloat16),
            det=td.fused_detector_consts(params, basis, lo, hi, d))
        for d in (dev, torch.device("cpu"))
    }
    ac = consts[dev]
    cases = {  # name: (kernel fwd, plain fwd, kernel bwd, plain bwd, consts of a device)
        "detector_fused": (td.detector_fused_fwd, td.detector_fused_fwd_plain,
                           td.detector_fused_bwd, td.detector_fused_bwd_plain,
                           lambda c: c.det),
        "analysis_detector": (tad.analysis_detector_fwd, tad.analysis_detector_fwd_plain,
                              tad.analysis_detector_bwd, tad.analysis_detector_bwd_plain,
                              lambda c: c),
    }
    worst: dict = {}
    for t in frames:
        for seed in range(seeds):
            rng = np.random.default_rng(1000 * seed + t)
            nb = hi - lo
            cs = np.zeros((batch, t, 2 * td.P_BAND), np.float32)
            cs[..., :nb] = 0.1 * rng.standard_normal((batch, t, nb))
            cs[..., td.P_BAND : td.P_BAND + nb] = 0.1 * rng.standard_normal((batch, t, nb))
            y2 = (0.8 * np.tanh(rng.standard_normal((batch, t - 1, hop)))).astype(np.float32)
            g = np.zeros((batch, td.CH[4]), np.float32)
            g[:, : td.N_BITS] = rng.standard_normal((batch, td.N_BITS))
            g = torch.as_tensor(g, device=dev)
            for name, (fk, fp, bk, bp, pick) in cases.items():
                x_np = cs if name == "detector_fused" else y2
                x = torch.as_tensor(x_np, device=dev)
                moved = torch.as_tensor(
                    x_np * (1 + 1e-6 * rng.standard_normal(x_np.shape)).astype(np.float32),
                    device=dev)
                c = pick(ac)
                _, res_k = fk(x, c)
                _, res_p = fp(x, c)
                _, res_m = fp(moved, c)
                _, res_cpu = fp(x.cpu(), pick(consts[torch.device("cpu")]))
                row = {f"fwd {k}": v for k, v in forward_report(res_k, res_p).items()}
                row.update({f"self {k}": v for k, v in forward_report(res_m, res_p).items()})
                row["plain cpu: pred"] = forward_report(
                    res_cpu, td.DetResiduals(*(v.cpu() for v in res_p)))["pred"]
                ref = bp(g, res_p, c)
                for label, got in (("vjp", bk(g, res_p, c)), ("chain", bk(g, res_k, c)),
                                   ("self chain", bp(g, res_m, c))):
                    row.update({f"{label} {k}": v for k, v in vjp_report(got, ref).items()})
                print(f"{name} T={t} B={batch} seed {seed}: {fmt(row)}", flush=True)
                for k, v in row.items():
                    key = (name, t, k)
                    worst[key] = max(worst.get(key, 0.0), v)
    print(f"largest readings over {seeds} seeds:")
    for (name, t, k), v in sorted(worst.items()):
        print(f"  {name} T={t} {k}: {v:.3e}")


def _speech_clips(rng, batch: int, n: int):
    """``batch`` speech-like clips of n samples at 16 kHz, (B, n) float64."""
    import numpy as np

    tt = np.arange(n) / 16000
    clips = []
    for _ in range(batch):
        ph = np.cumsum(2 * np.pi * (rng.uniform(100, 180) + 25 * np.sin(2 * np.pi * 2.3 * tt))
                       / 16000)
        x = sum(np.cos(k * ph) / k for k in range(1, 25))
        x = x * (0.4 + 0.6 * np.clip(np.sin(2 * np.pi * 3.1 * tt), 0, None))
        x = x + 0.02 * rng.standard_normal(n)
        clips.append(x / np.max(np.abs(x)))
    return np.stack(clips)


def iteration_problem(t: int, batch: int, seed: int, device):
    """Operands of the whole-iteration kernels for ``batch`` speech-like
    clips of ``t`` frames (noise and pitch from ``seed``), built by the
    solver's build_problem on the default card: (ct0 (B, T, P), IterConsts,
    the padded messages wm (B, 128), a cotangent g (B, 128))."""
    import numpy as np

    from aware_tpu_torch.config import AwareConfig
    from aware_tpu_torch.embed.solver import build_problem
    from aware_tpu_torch.models.detector import DetectorNet, load_key_params, params_from_jax

    rng = np.random.default_rng(seed)
    cfg = AwareConfig()
    clips = _speech_clips(rng, batch, (t - 1) * cfg.hop_length)
    bits = rng.integers(0, 2, (batch, 20))
    wm = torch.zeros(batch, 128, device=device)
    wm[:, :20] = torch.as_tensor(2.0 * bits - 1.0, dtype=torch.float32, device=device)
    g = torch.zeros(batch, 128, device=device)
    g[:, :20] = torch.as_tensor(rng.standard_normal((batch, 20)), dtype=torch.float32,
                                device=device)
    net = DetectorNet(params_from_jax(load_key_params()), cfg.detection_net).to(device)
    pb = build_problem(net, torch.as_tensor(clips, dtype=torch.float32, device=device),
                       wm[:, :20], cfg)
    return pb.ct0, pb.iteration, wm, g


def _iteration_readings(seeds: int, frames: tuple[int, ...], batch: int, dev) -> None:
    """The readings behind the whole-iteration kernels' bounds: each
    kernel against its plain version, and the plain version against itself
    with its input (ct, or g for the VJP) moved by 1e-6 of itself."""
    from aware_tpu_torch.ops.kernels import iteration as it
    from aware_tpu_torch.ops.kernels.roundtrip import phase_fold_plain

    worst: dict = {}
    k = it.nadam_coefs()
    for t in frames:
        for seed in range(seeds):
            ct, c, wm, g = iteration_problem(t, batch, 1000 * seed + t, dev)
            gen = torch.Generator(device=dev).manual_seed(seed)
            moved = ct * (1 + 1e-6 * torch.randn(ct.shape, generator=gen, device=dev))
            g_moved = g * (1 + 1e-6 * torch.randn(g.shape, generator=gen, device=dev))
            _, rk = it.iteration_forward_fwd(ct, c)
            _, rp = it.iteration_forward_fwd_plain(ct, c)
            _, rm = it.iteration_forward_fwd_plain(moved, c)
            row = {f"fwd {n}": v for n, v in forward_report(rk.det, rp.det).items()}
            row.update({f"self {n}": v for n, v in forward_report(rm.det, rp.det).items()})
            row.update({"fwd signal y2": _rel(rk.y2, rp.y2), "self signal y2": _rel(rm.y2, rp.y2)})
            ref = it.iteration_forward_bwd_plain(g, rp, c)
            for label, got in (("vjp", it.iteration_forward_bwd(g, rp, c)),
                               ("self vjp", it.iteration_forward_bwd_plain(g_moved, rp, c)),
                               ("chain", it.iteration_forward_bwd(g, rk, c)),
                               ("self chain", it.iteration_forward_bwd_plain(g, rm, c))):
                row.update({f"{label} {n}": v for n, v in vjp_report(got, ref).items()})
            b, _, p = ct.shape
            s = torch.full((b,), 0.1, device=dev)
            d2 = torch.full((1,), 1e-3, device=dev)
            losses, grads = [], []
            for fn, x in ((it.iteration_step, ct), (it.iteration_step_plain, ct),
                          (it.iteration_step_plain, moved)):
                state = [x.clone(), torch.zeros_like(x), torch.zeros_like(x), x.clone(),
                         torch.full((b,), float("inf"), device=dev)]
                bufs = it.step_buffers(b, t, 2 * p, c.env.shape[-1], dev)
                args = (x - x.abs() / 2, x + x.abs() / 2, wm, s, s, d2, c, k)
                if fn is it.iteration_step:
                    losses.append(fn(*state, *args, bufs).clone())
                    grads.append(phase_fold_plain(bufs.scratch.big, c.csin))
                else:
                    losses.append(fn(*state, *args))
                    pred, res = it.iteration_forward_fwd_plain(x, c)
                    grads.append(it.iteration_forward_bwd_plain(
                        it.push_extremes_grad(pred, wm)[1], res, c))
            row["step loss"] = _rel(losses[0], losses[1])
            row["self step loss"] = _rel(losses[2], losses[1])
            row.update({f"step grad {n}": v for n, v in vjp_report(grads[0], grads[1]).items()})
            row.update({f"self step grad {n}": v
                        for n, v in vjp_report(grads[2], grads[1]).items()})
            print(f"iteration T={t} B={batch} seed {seed}: {fmt(row)}", flush=True)
            for key, v in row.items():
                worst[(t, key)] = max(worst.get((t, key), 0.0), v)
    print(f"iteration: largest readings over {seeds} seeds:")
    for (t, key), v in sorted(worst.items()):
        print(f"  iteration T={t} {key}: {v:.3e}")


def _short_solve_readings(seeds: int, frames: tuple[int, ...], dev) -> None:
    """The weight-decay path's outcome below 32 frames, where chip_smoke.py
    phase 3s holds only the outcome: per pair of speech-like clips of T
    frames (from the seed, as phase 3s draws them), the 400-iteration BER %
    per lane of the solve on the card as the path runs it (the
    iteration_forward forward's sm90 chain), on the card with its first
    WMMA chain (``_iteration_forward_fwd_wmma``) in its place, and of the
    plain solve on the CPU from the clips and from the clips moved by 1e-6
    of themselves; then, per variant, the lanes that read worse than the
    CPU plain solve's and the sign test of phase 3s (``short_outcome``)."""
    import numpy as np

    from aware_tpu_torch import load
    from aware_tpu_torch.embed.solver import embed_batch
    from aware_tpu_torch.ops.kernels import iteration as it

    opt = {"optimizer_params": {"lr": 0.1, "weight_decay": 1e-4}}
    emb, det = load(device=dev, **opt)
    _, det_cpu = load(device="cpu", **opt)
    sm90_fwd = it.iteration_forward_fwd
    lanes: dict = {}
    for t in frames:
        for seed in range(seeds):
            clips, bits, moved = short_lanes(seed, t, emb.cfg.hop_length)
            wm = torch.as_tensor(2.0 * bits - 1.0, dtype=torch.float32)
            row = {}
            for name, fwd in (("card sm90", sm90_fwd),
                              ("card WMMA fwd", it._iteration_forward_fwd_wmma)):
                it.iteration_forward_fwd = fwd  # _IterationForward looks it up per call
                try:
                    x = torch.as_tensor(clips, dtype=torch.float32, device=dev)
                    res = embed_batch(det.net, x, wm.to(dev), emb.cfg)
                finally:
                    it.iteration_forward_fwd = sm90_fwd
                row[name] = lane_ber(det.net, res.audio, bits)
            for name, x in (("cpu", clips), ("cpu moved", moved)):
                res = embed_batch(det_cpu.net, torch.as_tensor(x, dtype=torch.float32), wm,
                                  emb.cfg)
                row[name] = lane_ber(det_cpu.net, res.audio, bits)
            print(f"short solve T={t} seed {seed}: BER % per lane "
                  + "; ".join(f"{k} {v.tolist()}" for k, v in row.items()), flush=True)
            for k, v in row.items():
                lanes.setdefault((t, k), []).extend(v.tolist())
    print(f"short solve: against the CPU plain solve, {2 * seeds} lanes a T (W worse, L better):")
    for t in frames:
        for k in ("card sm90", "card WMMA fwd", "cpu moved"):
            worse, better, p, ok = short_outcome(lanes[(t, k)], lanes[(t, "cpu")])
            print(f"  T={t} {k}: W {worse}, L {better}, p {p:.3e}{'' if ok else ', refused'}")


def short_lanes(seed: int, t: int, hop: int = 256):
    """The clip pair of phase 3s's sign test for ``seed`` at T frames, from
    a generator of its own: (clips (2, (T-1) hop) float64, bits (2, 20),
    the clips moved by 1e-6 of themselves)."""
    import numpy as np

    rng = np.random.default_rng([seed, t, 3])
    clips = _speech_clips(rng, 2, (t - 1) * hop)
    bits = rng.integers(0, 2, (2, 20))
    moved = clips * (1 + 1e-6 * rng.standard_normal(clips.shape))
    return clips, bits, moved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--frames", type=int, nargs="+", default=[8, 9, 33, 97, 626])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--only", choices=("detector", "iteration", "short-solve"), default=None,
                    help="the detector kernels' readings, the whole-iteration kernels', or the "
                    "weight-decay solve's outcome below 32 frames")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("agreement: no CUDA card")
        return 1
    dev = torch.device("cuda")
    if args.only == "short-solve":
        _short_solve_readings(args.seeds, tuple(args.frames), dev)
        return 0
    if args.only != "iteration":
        _readings(args.seeds, tuple(args.frames), args.batch, dev)
    if args.only != "detector":
        _iteration_readings(args.seeds, tuple(args.frames), args.batch, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
