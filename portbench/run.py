"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It sets up (data from ``--seed`` on the card,
the program's state, warm jobs), measures jobs for ``--seconds``, reads the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics from a
``torch.profiler`` trace of the window (``--trace 1``), compares a sample of
the answers with the plain reference, and prints the numbers compared to
standard error and one JSON line to standard output. Every cell runs on one
card, in this process.

``--control 1`` puts the reference, computed in the control precision
(TF32), in the program's place: its run has to come out not correct.

It exits non-zero without a result when torch sees no card, when the cell
asks for more than one, and when ``jax``, ``jaxlib``, ``flax`` or ``heat_tpu`` is
loaded once the window has closed.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"  # every build and kernel cache of a run, at fixed paths in the checkout
sys.path.insert(0, str(ROOT))


def _cache_env():
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def _emit(line: dict):
    found = line.pop("_found")
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}; no result", file=sys.stderr, flush=True)
        raise SystemExit(3)
    for name, v in line["compared"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_env()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if chips != 1:
        print(f"portbench: {args.workload} asks for {chips} cards; this harness runs cells on one", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print(f"portbench: {args.workload} needs a CUDA card, torch sees none; no result", file=sys.stderr)
        return 2
    from portbench import harness

    opts = {"workload": args.workload, "seed": args.seed, "seconds": args.seconds, "trace": args.trace,
            "control": args.control, "t0": T0, "device": "cuda"}
    _emit(harness.run(opts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
