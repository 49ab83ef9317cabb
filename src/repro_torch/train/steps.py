"""Train steps for the big-model path (the JAX package's
``train/steps.py``).

Two step builders:
 - ``make_train_step``            standard training (the naive-FL /
                                  dense-DP baseline the paper compares
                                  against);
 - ``make_zampling_train_step``   training-by-sampling on scores: the
                                  paper's system.  Per step: p=clip(s),
                                  z~Bern(p) (straight-through), w=Qz,
                                  CE loss, the optimizer on s.

Both close over the model (and the spec set) and run one model, its
parameters a flat {path: leaf} dict without the client axis (the
model's K-client forward sees them as K=1).  Where the JAX zampling
step folds the step counter into a PRNG key, the port's takes the
step's uint32 draw word itself; the optimizers see flat {path: leaf}
dicts, the zampling state ``{"scores": {...}, "dense": {...}}``
flattened.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..core.zampling import MaskProgram, ZamplingSpecs
from ..models.model import Model
from ..optim import Optimizer, apply_updates


class TrainState(NamedTuple):
    trainable: Any  # params (standard) or {'scores','dense'} (zampling)
    opt: Any
    step: torch.Tensor


def _flat(trainable) -> dict:
    """A zampling state's flat {path: leaf} dict, or params as given."""
    if set(trainable) == {"scores", "dense"}:
        return {**trainable["scores"], **trainable["dense"]}
    return dict(trainable)


def init_train_state(trainable, optimizer: Optimizer) -> TrainState:
    leaf = next(iter(_flat(trainable).values()))
    return TrainState(trainable, optimizer.init(_flat(trainable)),
                      torch.zeros((), dtype=torch.int32, device=leaf.device))


def _one_model_loss(model: Model, params, batch) -> torch.Tensor:
    """The model's loss on one model's params and a (B, S) batch."""
    return model.loss({p: v[None] for p, v in params.items()},
                      {n: v[None] for n, v in batch.items()})[0]


def make_train_step(model: Model, optimizer: Optimizer):
    def step(state: TrainState, batch):
        leaves = {p: t.detach().requires_grad_(True)
                  for p, t in state.trainable.items()}
        loss = _one_model_loss(model, leaves, batch)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        updates, opt = optimizer.update(grads, state.opt, leaves)
        params = apply_updates({p: t.detach() for p, t in leaves.items()},
                               updates)
        return TrainState(params, opt, state.step + 1), {
            "loss": loss.detach()}

    return step


def make_zampling_train_step(model: Model, zspecs: ZamplingSpecs,
                             optimizer: Optimizer):
    """``step(state, batch, word)``: one network drawn at the uint32
    draw word ``word`` (the fused sample-reconstruct kernel), its loss
    and gradients in every score and dense leaf, the optimizer's
    update."""
    program = MaskProgram(zspecs)

    def step(state: TrainState, batch, word):
        leaves = {p: t.detach().requires_grad_(True)
                  for p, t in _flat(state.trainable).items()}
        params = program.weights({p: leaves[p] for p in zspecs.specs},
                                 {p: leaves[p] for p in zspecs.dense_paths},
                                 word)
        loss = _one_model_loss(model, params, batch)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        updates, opt = optimizer.update(grads, state.opt, leaves)
        new = apply_updates({p: t.detach() for p, t in leaves.items()},
                            updates)
        trainable = {"scores": {p: new[p] for p in zspecs.specs},
                     "dense": {p: new[p] for p in zspecs.dense_paths}}
        return TrainState(trainable, opt, state.step + 1), {
            "loss": loss.detach()}

    return step
