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

The cache keeps the reference's layout: K/V of (B, max_len, nkv, hd)
per GQA layer, MLA's latent c_kv (B, max_len, rank) and k_rope (B,
max_len, rope), and for the SSM layers a conv state (B, W-1, conv_dim)
and an SSM state (B, h, n, p) whose size does not depend on max_len;
each step writes its position, or the new states, in place. An enc-dec
arch takes ``enc_frames`` (B, T_enc, d_model): before the prompt, the
encoder runs once over them (bidirectional, under the config's
``attn_impl``: with ``flash``, B7 once per encoder layer) and each
decoder layer's cross K/V are written into the cache's ``cross_k`` /
``cross_v`` (``_fill_cross_attn``), which every decode step reads.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import seeded_generator
from ..models import attention, transformer
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

    def _prefill_caches(self, prompts: torch.Tensor, enc_frames=None):
        """Run the prompt through decode_step token by token (after the
        encoder, for an enc-dec arch given ``enc_frames``)."""
        B, P = prompts.shape
        cache = self.model.init_cache(B, self.max_len, self.device)
        if enc_frames is not None:
            cache = self._fill_cross_attn(cache, enc_frames)
        logits = None
        for t in range(P):
            logits, cache = self.model.decode_step(
                self.params, prompts[:, t:t + 1], cache, t)
        return logits, cache, P

    @torch.no_grad()
    def _fill_cross_attn(self, cache, enc_frames):
        """The encoder over ``enc_frames`` (as given; float64 arrays as
        float32, as JAX takes them), then each decoder layer's cross K/V
        of its output, written into ``cross_k`` / ``cross_v``."""
        cfg = self.model.cfg
        frames = torch.as_tensor(enc_frames, device=self.device)
        if frames.dtype == torch.float64:
            frames = frames.float()
        enc = transformer.encode(self.params, frames, cfg)
        for i, lp in enumerate(self.params["layers"]):
            k, v = attention.encode_cross_kv(lp["cross"], enc, cfg)
            cache["cross_k"][i].copy_(k)
            cache["cross_v"][i].copy_(v)
        return cache

    def generate(self, prompts, max_new: int = 32, temperature: float = 0.0,
                 eos_id: Optional[int] = None, enc_frames=None,
                 seed: int = 0) -> ServeResult:
        transformer.check_enc_frames(self.model.cfg, enc_frames)
        prompts = torch.as_tensor(prompts, dtype=torch.int64,
                                  device=self.device)
        B, P = prompts.shape
        assert P + max_new <= self.max_len
        logits, cache, pos = self._prefill_caches(prompts, enc_frames)
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
