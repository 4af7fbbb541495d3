"""The train state (``rcu_tpu.engine.state`` counterpart): the model, which
holds the parameters and the BatchNorm statistics, the optimizer and its
state, the epoch and the best validation score; and its round trip to the
flax trees of the JAX package's checkpoints."""
from __future__ import annotations

import dataclasses
import math

import torch

from rcu_tpu_torch.models.convert import (flax_from_state_dict,
                                          state_dict_from_flax)
from rcu_tpu_torch.utils import profiling


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: object  # models.optim.Adam or SGD
    opt_state: dict
    epoch: int = 0
    best_score: float = -math.inf

    @property
    def params(self) -> dict:
        """The model's named parameters, the optimizer's order."""
        return dict(self.model.named_parameters())

    def step(self):
        """One optimizer update from the parameters' gradients, which it
        then drops."""
        with profiling.span("train.optimizer"):
            params = self.params
            self.optimizer.step(params, self.opt_state)
            for p in params.values():
                p.grad = None

    def to_flax(self) -> dict:
        """``{params, batch_stats, opt_state}`` as flax trees of numpy
        arrays (the checkpoint payload's model part)."""
        params, batch_stats = flax_from_state_dict(self.model.state_dict())
        return {"params": params, "batch_stats": batch_stats,
                "opt_state": self.optimizer.to_flax(self.opt_state,
                                                    self.params)}

    def load_flax(self, raw: dict):
        """Restore the model and the optimizer state from a checkpoint
        payload (the port's or the JAX package's), in place."""
        device = next(self.model.parameters()).device
        state = state_dict_from_flax(raw["params"], raw["batch_stats"])
        self.model.load_state_dict({k: v.to(device) for k, v in state.items()})
        self.opt_state = self.optimizer.from_flax(raw["opt_state"], self.params)


def create_train_state(model, optimizer, seed: int, device) -> TrainState:
    """Initialize ``model`` as flax initializes (``reset_parameters_like_
    flax``) from a CPU generator seeded with ``seed``, so that the weights
    do not depend on the device; move it to ``device`` and give it a
    fresh optimizer state."""
    model.reset_parameters_like_flax(torch.Generator().manual_seed(seed))
    model.to(device)
    return TrainState(model, optimizer,
                      optimizer.init(dict(model.named_parameters())))
