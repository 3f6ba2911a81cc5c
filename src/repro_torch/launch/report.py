"""Render the dry run's tables from its artifacts (port of
``repro/launch/report.py``):

  python -m repro_torch.launch.report [roofline [MESH] | dryrun] [--dir DIR]

``DIR`` defaults to ``artifacts/dryrun_torch`` (``launch/dryrun.py``'s).
The terms are the H100 model's: the data sheet's constants
(``core/hardware.py::H100``) over the counted work, not a measurement.
"""
from __future__ import annotations

import argparse
import json
import pathlib

ARTIFACTS = pathlib.Path(__file__).resolve().parents[3] / "artifacts" \
    / "dryrun_torch"


def load_cells(directory=None):
    cells, skips = [], []
    for f in sorted(pathlib.Path(directory or ARTIFACTS).glob("*.json")):
        d = json.loads(f.read_text())
        if "skipped" in d:
            skips.append(d)
        else:
            cells.append(d)
    return cells, skips


def fraction(d):
    """Roofline fraction: compute term / modeled step time (max of terms)."""
    r = d["roofline"]
    return r["compute_s"] / max(r["step_time_s"], 1e-12)


def roofline_table(mesh="16x16", directory=None):
    cells, skips = load_cells(directory)
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "roofline frac | useful FLOPs | peak GiB (scan/analytic) | fits |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for d in sorted(cells, key=lambda d: (d["arch"], d["shape"])):
        if d["mesh"] != mesh:
            continue
        r = d["roofline"]
        m = d["memory"]
        lines.append(
            f"| {d['arch']} | {d['shape']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.3f} | "
            f"{r['dominant']} | {fraction(d) * 100:.1f}% | "
            f"{d['useful_flops_ratio']:.2f} | "
            f"{m['peak_bytes'] / 2**30:.1f} / "
            f"{m['analytic_peak_bytes'] / 2**30:.1f} | "
            f"{'Y' if m['fits_hbm_analytic'] else 'N'} |")
    for d in sorted(skips, key=lambda d: d["arch"]):
        lines.append(f"| {d['arch']} | {d['shape']} | — | — | — | — | — | — "
                     f"| — | skip: {d['skipped'][:40]}… |")
    return "\n".join(lines)


def dryrun_table(directory=None):
    cells, _ = load_cells(directory)
    lines = [
        "| arch | shape | mesh | FLOPs/dev | bytes/dev | ICI wire | DCN wire "
        "| #coll | compile s |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for d in sorted(cells, key=lambda d: (d["arch"], d["shape"], d["mesh"])):
        r = d["roofline"]
        lines.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | "
            f"{r['flops']:.2e} | {r['bytes']:.2e} | "
            f"{r['ici_wire_bytes'] / 2**30:.2f} GiB | "
            f"{r['dcn_wire_bytes'] / 2**30:.2f} GiB | "
            f"{r['n_collectives']} | {d['compile_s']:.0f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="roofline",
                    choices=("roofline", "dryrun"))
    ap.add_argument("mesh", nargs="?", default="16x16")
    ap.add_argument("--dir", default=None,
                    help="artifacts directory (default: artifacts/dryrun_torch)")
    args = ap.parse_args(argv)
    if args.which == "roofline":
        print(roofline_table(args.mesh, args.dir))
    else:
        print(dryrun_table(args.dir))


if __name__ == "__main__":
    main()
