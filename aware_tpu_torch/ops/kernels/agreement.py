"""How closely the detector kernels must agree with their plain versions.

``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold the CUDA kernels of
``detector.py`` and ``analysis_detector.py`` to these bounds.  Run on a
card, this module takes the readings the bounds were set from:

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
version's own spread over eight seeds (PERF.md has the readings).
"""

from __future__ import annotations

import argparse

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
# (below, one flip turns the plain chain itself by up to 1 - cosine 0.19)
CHAIN_TOL = {"1-cos": 3e-2, "norm": 5e-3}


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


def check_forward(res_k, res_p, t: int) -> dict:
    """Raise AssertionError where the kernel's forward (pred and every
    residual) departs from the plain one's by more than the bounds; return
    the report."""
    for name, a, b in zip(res_p._fields, res_k, res_p):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert bool(torch.isfinite(a.float()).all()), f"{name} is not finite"
    r = forward_report(res_k, res_p)
    short = int(t < SHORT_FRAMES)
    bad = [n for n, tol in FWD_TOL.items() if not r[n] <= tol[short]]
    bad += [n + "_share" for n, tol in SHARE_TOL.items() if not r[n + "_share"] <= tol]
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


def check_vjp(out_k: torch.Tensor, out_p: torch.Tensor, chain: bool = False) -> dict:
    """The VJP kernel against the plain VJP from the same residuals, or
    (``chain``) the kernel forward then backward against the plain chain."""
    assert out_k.shape == out_p.shape, (out_k.shape, out_p.shape)
    assert bool(torch.isfinite(out_k).all()), "the cotangent is not finite"
    r = vjp_report(out_k, out_p)
    bad = [k for k, tol in (CHAIN_TOL if chain else VJP_TOL).items() if not r[k] <= tol]
    assert not bad, f"{'chain' if chain else 'VJP'} departs from the plain one in {bad}: {fmt(r)}"
    return r


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--frames", type=int, nargs="+", default=[8, 9, 33, 97, 626])
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("agreement: no CUDA card")
        return 1
    _readings(args.seeds, tuple(args.frames), args.batch, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
