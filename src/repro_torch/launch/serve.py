"""Serving launcher: batched generation with the Engine, as
``repro/launch/serve.py``, on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --requests 4 --prompt-len 16 --max-new 24 [--device cpu]

Runs the arch's smoke config with random weights from ``--seed``; an
enc-dec arch (whisper-medium) also takes frame embeddings drawn from the
seed, as the reference draws them. ``main`` returns the
``ServeResult``.
"""
import argparse
import time

import numpy as np
import torch

from ..configs import get_smoke
from ..models import build_model
from ..serving import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch)
    model = build_model(cfg)
    params = model.init(args.seed, args.device)
    engine = Engine(model, params,
                    max_len=args.prompt_len + args.max_new + 8)

    rng = np.random.RandomState(args.seed)
    prompts = rng.randint(0, cfg.vocab_size,
                          size=(args.requests, args.prompt_len))
    enc = None
    if cfg.is_enc_dec:
        enc = torch.as_tensor(
            rng.randn(args.requests, cfg.encoder_seq_len, cfg.d_model),
            dtype=torch.float32) * 0.1

    t0 = time.time()
    res = engine.generate(prompts, max_new=args.max_new,
                          temperature=args.temperature, enc_frames=enc,
                          seed=args.seed)
    dt = time.time() - t0
    toks = args.requests * args.max_new
    print(f"generated {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s batched)")
    for i in range(min(2, args.requests)):
        print(f"req{i}: {res.tokens[i][:16].tolist()} ...")
    return res


if __name__ == "__main__":
    main()
