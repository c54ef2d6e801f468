#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``) names its
configuration and traffic; set-up makes the inputs from ``--seed``,
warms the cell's shapes and builds the kernels (into the checkout's
``build/``); the window runs for ``--seconds``; then the plain
reference judges what the window's path produced. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and ``checked`` last: each compared number beside its
limit); the compared numbers are also the last lines of standard
error. Exits 2 without the cards the cell asks for, and 3 if JAX or the
JAX package was loaded.
"""
import time


def _process_start() -> float:
    """When this process started, on time.time()'s clock (Linux), so
    that set-up counts the interpreter's start as well."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import os
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "perfbench" / "out" / "cache"
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                 ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from perfbench.harness import cell as cell_mod
    from perfbench.harness import manifest

    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = cell_mod.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace),
                       device=torch.device("cuda", 0), t_start=T_START)
    out = cell_mod.execute(run)
    result = cell_mod.line(run, out)
    found = cell_mod.loaded_forbidden()
    if found:
        print(f"refused: modules {found} were loaded in this process",
              file=sys.stderr)
        return 3
    for key, value in out.notes.items():
        print(f"{key}: {value}", file=sys.stderr)
    for c in out.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
