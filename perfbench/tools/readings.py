#!/usr/bin/env python3
"""Print the readings a cell's limits are set from (``harness/readings.py``),
on the card at the cell's own size, one JSON line per seed and mode:

    python3 perfbench/tools/readings.py --workload <name> \
        --seeds 11,12,13 [--epochs E]

``--epochs``: a flat solve's epochs, as many as a run makes.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT)]

import torch  # noqa: E402

from perfbench.harness import manifest, readings  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--epochs", type=int, default=1250)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        if cell.config["driver"] == "flat_solve":
            found = readings.flat_readings(cell, seed, args.epochs, dev)
        else:
            found = readings.train_readings(cell, seed, dev)
        for mode, gaps in found:
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "mode": mode, **gaps,
                              "s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
