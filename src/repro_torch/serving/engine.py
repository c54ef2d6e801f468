"""Batched serving engine: prefill + step-wise decode with KV caches —
a port of ``repro/serving/engine.py``.

The prompt batch is run through ``decode_step`` token by token (as the
reference does: simple, and right for every cache family), the last
position's logits seed the decode loop, and a per-request activity mask
handles early EOS. Greedy decoding takes ``argmax`` (the first maximum,
as JAX's); temperature sampling draws Gumbel noise from a
``torch.Generator`` seeded by ``seed`` (the reference's
``jax.random.categorical`` is the same Gumbel-max rule on threefry
draws, so sampled tokens differ between the packages).

The KV cache keeps the reference's layout, (B, max_len, nkv, hd) per
layer, and each step writes its position in place. ``enc_frames`` (the
enc-dec family) waits for its slice (ROADMAP Queue A item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import seeded_generator
from ..models.model import Model


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray          # (B, max_new) generated ids
    steps: int


class Engine:
    def __init__(self, model: Model, params, max_len: int = 512):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.device = next(params.parameters()).device

    def _prefill_caches(self, prompts: torch.Tensor):
        """Run the prompt through decode_step token by token."""
        B, P = prompts.shape
        cache = self.model.init_cache(B, self.max_len, self.device)
        logits = None
        for t in range(P):
            logits, cache = self.model.decode_step(
                self.params, prompts[:, t:t + 1], cache, t)
        return logits, cache, P

    def generate(self, prompts, max_new: int = 32, temperature: float = 0.0,
                 eos_id: Optional[int] = None, enc_frames=None,
                 seed: int = 0) -> ServeResult:
        if enc_frames is not None:
            raise NotImplementedError(
                "enc_frames belong to the enc-dec family, not ported yet "
                "(ROADMAP Queue A item 11)")
        prompts = torch.as_tensor(prompts, dtype=torch.int64,
                                  device=self.device)
        B, P = prompts.shape
        assert P + max_new <= self.max_len
        logits, cache, pos = self._prefill_caches(prompts)
        gen = seeded_generator(self.device, seed) if temperature > 0.0 \
            else None
        out = []
        active = torch.ones((B,), dtype=torch.bool, device=self.device)
        for t in range(max_new):
            last = logits[:, -1, :]
            if temperature > 0.0:
                u = torch.rand(last.shape, generator=gen, device=self.device)
                gumbel = -torch.log(-torch.log(u))
                tok = torch.argmax(last / temperature + gumbel, dim=-1)
            else:
                tok = torch.argmax(last, dim=-1)
            if eos_id is not None:
                tok = torch.where(active, tok, eos_id)
                active = active & (tok != eos_id)
            out.append(tok)
            logits, cache = self.model.decode_step(
                self.params, tok[:, None], cache, pos + t)
        # int32, as the reference's argmax gives them
        tokens = torch.stack(out, dim=1).to(torch.int32)
        return ServeResult(tokens=tokens.cpu().numpy(), steps=max_new)
