"""The readings that the limits of ``correct`` are set from: the cell's
comparison on many seeds, for the program and for the control, in one
process (set-up is long beside a short window).

    python3 portbench/readings.py --workload <cell> --seconds <s> \\
        --seeds <n,n,...> [--control-seeds <n,n,...>] [--out <file>]

Each seed is a whole run of the cell (set-up, a window of ``--seconds``
at the cell's own load, the comparison) without its metrics; it prints one
JSON line a seed: the seed, whether it ran the control, and the numbers
compared. The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args()
    plan = [(int(s), 0) for s in args.seeds.split(",") if s] + [(int(s), 1) for s in args.control_seeds.split(",") if s]
    import torch

    if not torch.cuda.is_available():
        print(f"readings: {args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    from portbench import harness

    lines = []
    for seed, control in plan:
        opts = {"workload": args.workload, "seed": seed, "seconds": args.seconds, "trace": 0, "control": control,
                "t0": time.time(), "device": "cuda"}
        line = harness.run(opts)
        out = {"seed": seed, "control": control, "correct": line["correct"], "attempted": line["attempted"],
               "compared": {k: v["value"] for k, v in line["compared"].items()}, "found": line["_found"]}
        print(json.dumps(out), flush=True)
        lines.append(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
