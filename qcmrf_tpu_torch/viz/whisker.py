"""Figure generation: success-rate scatter + whisker plots (port of
:mod:`qcmrf_tpu.viz.whisker`).

Loops the three prior scales for one backend, collects ``(||theta||_inf,
fidelity / success)`` pairs for graph index 1 (as the reference's
``whisker.py`` does), and renders a two-panel figure: the empirical
success rate against the parameter norm, and a box plot of the success
rate per scale, saved as ``success_{backend}.pdf``.

The exact Gibbs laws come from :meth:`MRF.gibbs_probs` on ``device`` (the
log-potential and logsumexp kernels on the card unless the caller names
the CPU). :func:`render` draws with matplotlib (imported there) where it
is installed; where it is not, it writes the same two panels as a plain
one-page PDF of its own (:func:`render_plain`: lines, marks and the
standard Helvetica and Courier fonts, no package needed).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np

from qcmrf_tpu_torch.evaluation import metrics
from qcmrf_tpu_torch.evaluation.harness import load_result_dists
from qcmrf_tpu_torch.models.mrf import MRF
from qcmrf_tpu_torch.models.suite import generate_suite, load_suite
from qcmrf_tpu_torch.utils.config import resolve_device

SCALES = [0.1, 0.25, 0.5]
FOCUS_GRAPH = 1  # the reference collects graph index 1 only


def collect(backend: str, res_root: str = ".", device=None):
    """Per-scale evaluation loop; returns (fidelity rows, success rows,
    whisker data). Runs on ``device``, the current CUDA device unless one
    is named."""
    device = resolve_device(device)
    L_F, L_delta, WH = [], [], {}
    for scale in SCALES:
        res_dir = os.path.join(res_root, f"res_{scale:g}")
        suite = None
        for name in (f"models_{scale:g}.json", "models.json"):
            p = os.path.join(res_dir, name)
            if os.path.isfile(p):
                suite = load_suite(p, scale)
                break
        if suite is None:
            suite = generate_suite(scale)
        dists, norm = load_result_dists(
            os.path.join(res_dir, f"result_{backend}.json")
        )
        WH[scale] = []
        idx = sum(len(suite.thetas[j]) for j in range(FOCUS_GRAPH))
        C = suite.graphs[FOCUS_GRAPH]
        for theta in suite.thetas[FOCUS_GRAPH]:
            mrf = MRF.create(C, theta=theta, device=device)
            N = mrf.num_states
            p = mrf.gibbs_probs().cpu().numpy().astype(np.float64)
            q = np.zeros(N)
            Z = 0.0
            for k, v in dists[idx].items():
                kid = int(k, 2)
                if kid < N:
                    q[kid] = v
                    Z += v
            q = q / Z if Z else q
            mF = float(np.clip(float(metrics.fidelity(p, q)), 0, 1))
            w_nrm = float(np.linalg.norm(theta, ord=np.inf))
            L_F.append((w_nrm, mF))
            L_delta.append((w_nrm, Z / norm))
            WH[scale].append(Z / norm)
            idx += 1
    return np.array(L_F), np.array(L_delta), WH


def render(backend: str, L_delta: np.ndarray, WH: Dict[float, List[float]],
           out_path: Optional[str] = None, use_tex: bool = False) -> str:
    """Write the figure with matplotlib where it is installed, else with
    :func:`render_plain`."""
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        return render_plain(backend, L_delta, WH, out_path)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.figure import figaspect

    if use_tex:
        plt.rc("text", usetex=True)

    width, height = figaspect(0.5)
    fig, axes = plt.subplots(nrows=1, ncols=2, figsize=(width, height))
    for ax in axes:
        ax.spines["top"].set_visible(False)
        ax.spines["right"].set_visible(False)
    plt.subplots_adjust(wspace=0.5, hspace=0.5)

    axes[0].scatter(L_delta[:, 0], L_delta[:, 1])
    axes[0].set_xlabel(r"Parameter norm $\|\theta\|_{\infty}$")
    axes[0].set_ylabel(r"Empirical success rate $\hat{\delta}$")

    axes[1].boxplot([WH[k] for k in WH])
    axes[1].set_xlabel(r"Scale $\sigma$")
    axes[1].set_ylabel(r"Estimated success rate $\hat{\delta}$")
    axes[1].set_xticklabels([str(s) for s in WH])

    plt.suptitle(backend, family="monospace")
    out = out_path or f"./success_{backend}.pdf"
    plt.savefig(out)
    plt.close(fig)
    return out


def _ticks(lo: float, hi: float, count: int = 5) -> np.ndarray:
    """Round tick values spanning [lo, hi]: a step of 1, 2, 2.5 or 5 times
    a power of ten."""
    span = max(hi - lo, 1e-12)
    raw = span / count
    mag = 10.0 ** np.floor(np.log10(raw))
    step = next(m * mag for m in (1, 2, 2.5, 5, 10) if m * mag >= raw)
    return np.arange(np.ceil(lo / step) * step, hi + 1e-9 * span, step)


def _box_stats(v) -> dict:
    """matplotlib's box statistics: quartiles by linear interpolation,
    whiskers at the farthest data within 1.5 IQR, the rest fliers."""
    v = np.asarray(v, np.float64)
    q1, med, q3 = np.percentile(v, [25, 50, 75])
    iqr = q3 - q1
    inside = v[(v >= q1 - 1.5 * iqr) & (v <= q3 + 1.5 * iqr)]
    return dict(q1=q1, med=med, q3=q3, lo=inside.min(), hi=inside.max(),
                fliers=v[(v < inside.min()) | (v > inside.max())])


def render_plain(backend: str, L_delta: np.ndarray,
                 WH: Dict[float, List[float]],
                 out_path: Optional[str] = None) -> str:
    """The figure of :func:`render` as a one-page PDF written directly:
    the scatter of success rate against parameter norm, and a box plot of
    the success rate per scale (matplotlib's statistics)."""
    W, H = 691.2, 345.6  # figaspect(0.5) at 72 points an inch
    ops: List[str] = []

    def text(x, y, s, size=9, font="F1", angle=0.0):
        """``s`` centred on (x, y) along ``angle`` degrees."""
        s = s.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")
        w = 0.5 * size * len(s)  # about Helvetica's mean advance
        c, si = np.cos(np.radians(angle)), np.sin(np.radians(angle))
        x0, y0 = x - 0.5 * w * c, y - 0.5 * w * si
        ops.append(f"BT /{font} {size} Tf {c:.4f} {si:.4f} {-si:.4f} "
                   f"{c:.4f} {x0:.2f} {y0:.2f} Tm ({s}) Tj ET")

    def line(x0, y0, x1, y1):
        ops.append(f"{x0:.2f} {y0:.2f} m {x1:.2f} {y1:.2f} l S")

    def dot(x, y, r=2.5, fill=True):
        k = 0.5523 * r  # four Bezier quarter circles
        ops.append(
            f"{x + r:.2f} {y:.2f} m "
            f"{x + r:.2f} {y + k:.2f} {x + k:.2f} {y + r:.2f} {x:.2f} "
            f"{y + r:.2f} c {x - k:.2f} {y + r:.2f} {x - r:.2f} {y + k:.2f} "
            f"{x - r:.2f} {y:.2f} c {x - r:.2f} {y - k:.2f} {x - k:.2f} "
            f"{y - r:.2f} {x:.2f} {y - r:.2f} c {x + k:.2f} {y - r:.2f} "
            f"{x + r:.2f} {y - k:.2f} {x + r:.2f} {y:.2f} c "
            + ("f" if fill else "S"))

    def axes(x0, x1, y0, y1, lo_x, hi_x, lo_y, hi_y, xticks, xlabels,
             xlabel, ylabel):
        line(x0, y0, x1, y0)
        line(x0, y0, x0, y1)

        def sx(v):
            return x0 + (v - lo_x) / (hi_x - lo_x) * (x1 - x0)

        def sy(v):
            return y0 + (v - lo_y) / (hi_y - lo_y) * (y1 - y0)

        for v, lab in zip(xticks, xlabels):
            line(sx(v), y0, sx(v), y0 - 3.5)
            text(sx(v), y0 - 14, lab)
        for v in _ticks(lo_y, hi_y):
            line(x0, sy(v), x0 - 3.5, sy(v))
            text(x0 - 6 - 2.5 * len(f"{v:g}"), sy(v) - 3, f"{v:g}")
        text(0.5 * (x0 + x1), y0 - 30, xlabel, size=10)
        text(x0 - 40, 0.5 * (y0 + y1), ylabel, size=10, angle=90.0)
        return sx, sy

    def padded(lo, hi):
        pad = 0.05 * max(hi - lo, 1e-6)
        return lo - pad, hi + pad

    ops.append("0.8 w 0 0 0 RG 0 0 0 rg")
    x, y = L_delta[:, 0], L_delta[:, 1]
    lo_x, hi_x = padded(x.min(), x.max())
    lo_y, hi_y = padded(y.min(), y.max())
    xt = _ticks(lo_x, hi_x)
    sx, sy = axes(86.4, 297.0, 52.0, 300.0, lo_x, hi_x, lo_y, hi_y, xt,
                  [f"{v:g}" for v in xt],
                  "Parameter norm ||theta||_inf",
                  "Empirical success rate delta-hat")
    ops.append("0.122 0.467 0.706 rg")  # matplotlib's first colour
    for a, b in zip(x, y):
        dot(sx(a), sy(b))
    ops.append("0 0 0 rg")
    scales = list(WH)
    allv = np.concatenate([np.asarray(WH[k], np.float64) for k in scales])
    lo_y, hi_y = padded(allv.min(), allv.max())
    sx, sy = axes(432.0, 648.0, 52.0, 300.0, 0.5, len(scales) + 0.5,
                  lo_y, hi_y, range(1, len(scales) + 1),
                  [str(k) for k in scales], "Scale sigma",
                  "Estimated success rate delta-hat")
    for i, k in enumerate(scales, start=1):
        b = _box_stats(WH[k])
        xl, xr = sx(i - 0.25), sx(i + 0.25)
        ops.append(f"{xl:.2f} {sy(b['q1']):.2f} {xr - xl:.2f} "
                   f"{sy(b['q3']) - sy(b['q1']):.2f} re S")
        line(sx(i), sy(b["q3"]), sx(i), sy(b["hi"]))
        line(sx(i), sy(b["q1"]), sx(i), sy(b["lo"]))
        for v in (b["lo"], b["hi"]):
            line(sx(i - 0.125), sy(v), sx(i + 0.125), sy(v))
        ops.append("1 0.498 0.055 RG")  # the median in orange
        line(xl, sy(b["med"]), xr, sy(b["med"]))
        ops.append("0 0 0 RG")
        for v in b["fliers"]:
            dot(sx(i), sy(v), fill=False)
    text(0.5 * W, H - 20, backend, size=12, font="F2")

    stream = "\n".join(ops).encode("latin-1")
    objs = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {W} {H}] "
         "/Contents 4 0 R /Resources << /Font << /F1 5 0 R /F2 6 0 R >> >> "
         ">>").encode(),
        b"<< /Length %d >>\nstream\n" % len(stream) + stream
        + b"\nendstream",
        b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>",
        b"<< /Type /Font /Subtype /Type1 /BaseFont /Courier >>",
    ]
    body = bytearray(b"%PDF-1.4\n")
    offsets = []
    for i, o in enumerate(objs, start=1):
        offsets.append(len(body))
        body += b"%d 0 obj\n" % i + o + b"\nendobj\n"
    xref = len(body)
    body += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objs) + 1)
    for off in offsets:
        body += b"%010d 00000 n \n" % off
    body += (b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
             % (len(objs) + 1, xref))
    out = out_path or f"./success_{backend}.pdf"
    with open(out, "wb") as f:
        f.write(bytes(body))
    return out


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        prog="Whisker plot for QCMRF success rate (PyTorch / CUDA).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--backend", type=str, default="simulation",
                        help="The backend.")
    parser.add_argument("--res-root", type=str, default=".")
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--platform", type=str, default="default",
                        choices=["cpu", "gpu", "default"],
                        help="Device for the exact Gibbs laws; 'default' "
                             "means 'gpu', and a GPU that is not there "
                             "raises.")
    from qcmrf_tpu_torch.utils.config import resolve_platform

    args = parser.parse_args(argv)
    device = resolve_platform(args.platform)
    _, L_delta, WH = collect(args.backend, args.res_root, device=device)
    out = render(args.backend, L_delta, WH, out_path=args.out)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
