"""Drive one cell through the harness on the CPU at a small size (tests only):

    python -m portbench.tests.cpu_run '<json options>'

The options are ``harness.run``'s (workload, seed, seconds, trace, control,
overrides, traffic_overrides, fault). It skips the command's look for a
card and prints the result line as the last line of standard output.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

T0 = time.time()
ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def main() -> int:
    opts = json.loads(sys.argv[1])
    opts.update(t0=T0, device="cpu")
    opts.setdefault("control", 0)
    if opts.get("fault"):
        opts["fault_module"] = str(Path(__file__).resolve().parent / "faults.py")
    line = harness.run(opts)
    if line.pop("_found"):
        raise SystemExit("a forbidden module was loaded")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
