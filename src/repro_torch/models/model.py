"""Public model API: a thin facade over ``transformer.py``, as
``repro/models/model.py``.

``Model`` bundles init / prefill / decode for one ``ModelConfig``; the
serving engine, the launcher and the tests go through it. ``loss`` and
``grad_fn`` wait for the training slice (ROADMAP Queue A item 11).
Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); inference runs without autograd.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..device import DeviceLike, resolve_device, seeded_generator
from . import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any

    # ---- params ----
    def init(self, seed: int = 0, device: DeviceLike = None
             ) -> transformer.ParamTree:
        """Random weights of the reference's distributions (``dense_init``,
        ``embed_init``), drawn on ``device`` from a generator seeded by
        ``seed``; the numbers differ from JAX's threefry draws."""
        dev = resolve_device(device)
        return transformer.init_params(seeded_generator(dev, seed), self.cfg,
                                       dev)

    # ---- inference ----
    @torch.no_grad()
    def prefill(self, params, tokens, enc_frames=None, logits_mode="all"):
        logits, _ = transformer.forward(params, tokens, self.cfg,
                                        enc_frames=enc_frames,
                                        logits_mode=logits_mode)
        return logits

    @torch.no_grad()
    def decode_step(self, params, token, cache, pos):
        return transformer.decode_step(params, token, cache, pos, self.cfg)

    def init_cache(self, batch: int, max_len: int, device: DeviceLike = None):
        return transformer.init_cache(self.cfg, batch, max_len,
                                      resolve_device(device))

    def cache_specs(self, batch: int, max_len: int):
        return transformer.init_cache_specs(self.cfg, batch, max_len)


def build_model(cfg) -> Model:
    return Model(cfg)
