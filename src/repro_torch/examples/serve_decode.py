"""Batched serving demo across architecture families (dense / MoE / SSM
/ hybrid): prefill + KV-cache decode with ragged request handling, a
port of ``examples/serve_decode.py``:

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        [--arch mamba2-370m] [--device cpu]

The default list is the reference's, one arch per family: qwen3-1.7b,
mixtral-8x7b, mamba2-370m (its decode state a constant-size SSM state)
and zamba2-1.2b (SSM layers and a shared attention block). Each arch
runs its smoke config with random weights from seed 0 and samples at
temperature 0.7 from seed 1 (a ``torch.Generator``: the sampled tokens
differ from the reference's threefry draws). On the card unless
``--device cpu``; ``main`` returns each printed line with its numbers.
"""
import argparse
import time

import numpy as np

from ..configs import get_smoke
from ..models import build_model
from ..serving import Engine

DEFAULT_ARCHS = ["qwen3-1.7b", "mixtral-8x7b", "mamba2-370m", "zamba2-1.2b"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="default: one per family")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else DEFAULT_ARCHS
    rows = []
    for arch in archs:
        cfg = get_smoke(arch)
        model = build_model(cfg)
        params = model.init(0, args.device)
        engine = Engine(model, params, max_len=64)
        prompts = np.random.RandomState(0).randint(
            0, cfg.vocab_size, (args.requests, 8))
        t0 = time.time()
        res = engine.generate(prompts, max_new=args.max_new, temperature=0.7,
                              seed=1)
        dt = time.time() - t0
        toks = args.requests * args.max_new
        line = (f"{arch:22s} {toks:4d} tokens in {dt:6.2f}s "
                f"({toks/dt:6.1f} tok/s)  sample: "
                f"{res.tokens[0][:8].tolist()}")
        print(line)
        rows.append(dict(arch=arch, tokens=res.tokens, seconds=dt,
                         tokens_per_s=toks / dt, line=line))
    return rows


if __name__ == "__main__":
    main()
