"""Run one cell of the port's benchmark once.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA H100s.
Cells, configurations, mixes and metrics are named in ``BENCHMARK.json``;
``bench/README.md`` says how the files they name are laid out. Prints the
check lines last on standard error and one JSON result as the last line
of standard output. Exits with a code other than 0, and prints no result,
when there is no Hopper card (or fewer than the cell asks for), when the
program (``src/repro_torch``) is missing, or when JAX or the JAX package
was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    # every cache of the program at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "bench" / sub)

    import torch
    from bench.lib import harness, spec

    cell = spec.Spec(ROOT).cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"bench: cell {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0)
    if torch.cuda.get_device_capability(0) != (9, 0) or "H100" not in name:
        print(f"bench: wants a Hopper H100, found {name}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"bench: the program is missing: {exc}", file=sys.stderr)
        return 2
    return harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda:0", T_START)


if __name__ == "__main__":
    sys.exit(main())
