"""The benchmark of the port: one run of one cell.

    python3 hgnnbench/run.py --workload han-dblp.train --seed 7 --seconds 30 --trace 0

Sets up the cell (inputs and weights from ``--seed``, the port's own
set-up, every shape warmed up), measures for ``--seconds``, judges what
the timed path produced against the plain reference, and prints one JSON
line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones from a profiled window), ``device`` and, last, ``checks``:
each compared number beside its limit, which also end standard error.

Runs on the card only: without CUDA, with fewer cards than the cell
asks for, without the port beside it (``src/repro_torch``), or with
``jax``, ``jaxlib``, ``flax`` or ``repro`` loaded once the window has
closed, it exits non-zero and prints no result.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no port beside the benchmark: {ROOT / 'src' / 'repro_torch'}", file=sys.stderr)
        return 2
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    # one host thread for the CPU libraries: idle worker threads that spin
    # beside the thread that launches the steps slow it down, and by how
    # much varies from process to process
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    torch.set_num_threads(1)
    from hgnnbench import harness

    want = harness.cell(harness.benchmark(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"needs {want} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                            start=START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(line))
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
