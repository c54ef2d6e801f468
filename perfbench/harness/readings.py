"""The readings a cell's limits are set from, beside the program's own
(the ``checked`` numbers of every run): the control, the reference one
precision below the configuration's in the program's place, and for a
training cell the faults planted in the reference put in its place,
each against the plain reference on the same seed and inputs.

Flat solve: the control is the reference in bfloat16 over as many
epochs as a run makes. Training: the control rounds both operands of
every matrix product to TF32; ``half_batch`` takes the loss over the
first half of each worker's sequences (of its tokens when it has one
sequence); ``altered_token`` changes worker 0's first input token of
the first step. A state left unchanged reads 1 by the change gap's
measure and needs no run.
"""
from __future__ import annotations

import torch

from ..drivers import admm_train, flat_solve
from ..reference import flat_admm
from . import inputs, traffic


def flat_readings(cell, seed, epochs, dev):
    cfg = cell.config
    s = flat_solve.settings(cell)
    N, M, dim = cfg["num_workers"], cfg["num_blocks"], cfg["dim"]
    edge = traffic.edges(cell.params["edges"], N, M, dev)
    c = inputs.centers(seed, N, dim, dev)
    want = flat_admm.replay(c, edge, s, seed, epochs)
    low = flat_admm.replay(c, edge, s, seed, epochs, dtype=torch.bfloat16)
    yield "control", flat_solve.state_gaps(low, want)


def half_batch(t, i, tokens, labels):
    if tokens.shape[0] > 1:
        half = tokens.shape[0] // 2
        return tokens[:half], labels[:half]
    half = tokens.shape[1] // 2
    return tokens[:, :half], labels[:, :half]


def altered_token(vocab):
    def alter(t, i, tokens, labels):
        if t == 0 and i == 0:
            tokens = tokens.clone()
            tokens[0, 0] = (tokens[0, 0] + 1) % vocab
        return tokens, labels
    return alter


def train_readings(cell, seed, dev):
    cfg, params = cell.config, cell.params
    s = admm_train.settings(cell)
    N, steps = int(s["num_workers"]), int(params["checked_steps"])

    def ref(**kw):
        return admm_train.reference_steps(cfg, s, seed, params, N, steps,
                                          dev, **kw)

    want = ref()
    modes = {"control": dict(round_tf32=True),
             "half_batch": dict(alter=half_batch),
             "altered_token": dict(alter=altered_token(cfg["vocab_size"]))}
    for mode, kw in modes.items():
        yield mode, admm_train.step_gaps(ref(**kw), want)
