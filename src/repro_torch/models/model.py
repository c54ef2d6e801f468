"""Public model API: a thin facade over ``transformer.py``, as
``repro/models/model.py``.

``Model`` bundles init / loss / prefill / decode for one ``ModelConfig``;
the trainers, the serving engine, the launchers and the tests go through
it. Training runs on the reference's stacked tree
(``weights.stacked_params``: ``layers`` leaves stacked on a leading L
axis), which ``loss`` differentiates under ``torch.func``; inference
runs on the ``ParamTree`` of ``init`` (``weights.params_from_stacked``
views a trained stacked tree as one) without autograd. Entry points run
on the card unless the caller asks for the CPU (``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..device import DeviceLike, resolve_device, seeded_generator
from . import transformer, weights
from .layers import cross_entropy


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

    def param_specs(self) -> Dict[str, Any]:
        """The stacked tree's shapes and dtypes without allocating: its
        leaves are tensors on the ``meta`` device."""
        return weights.stacked_params(self.cfg, device="meta")

    # ---- training ----
    def loss(self, params, batch) -> torch.Tensor:
        """Mean token cross-entropy plus the auxiliary loss. ``params``:
        the stacked tree; batch: {"tokens": (B, S), "labels": (B, S),
        ["label_mask"]}."""
        logits, aux = transformer.forward(
            params, batch["tokens"], self.cfg,
            enc_frames=batch.get("enc_frames"))
        return cross_entropy(logits, batch["labels"],
                             batch.get("label_mask")) + aux

    def grad_fn(self):
        """(params, batch) -> the gradient of ``loss`` as a stacked tree."""
        return torch.func.grad(self.loss)

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
