"""The port's static-analysis gate (graftlint + graftflow over heat_tpu_torch),
loaded by file path so it never imports torch.

Usage: ``python tools/torch_graftcheck.py [heat_tpu_torch/] [--format json] [--select G004,F001]``;
the exit code is graftcheck's bitmask (1 lint, 2 flow, 4 drift, 128 error).
"""
import importlib.util
import os
import sys

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "heat_tpu_torch", "analysis",
                     "graftcheck.py")

if __name__ == "__main__":
    spec = importlib.util.spec_from_file_location("_torch_graftcheck", _PATH)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    sys.exit(mod.main())
