"""Optimizers over dicts of tensors (counterpart of
mitsuba2_tpu/diff/optimizers.py): the functional SGD and Adam steps of
autodiff.py, with the same update formulas and defaults, and the
reference's stateful wrappers for scripts. No tape: a step takes
gradients (render_and_grad's) and returns new tensors."""
from __future__ import annotations

from typing import Dict

import torch


# --- functional core --------------------------------------------------------

def sgd_init(params):
    return {"momentum": {k: torch.zeros_like(p) for k, p in params.items()}}


def sgd_step(params, grads, state, lr: float, momentum: float = 0.0):
    """autodiff.py::SGD.step (with optional momentum)."""
    if momentum == 0.0:
        return {k: p - lr * grads[k] for k, p in params.items()}, state
    vel = {k: momentum * v + grads[k] for k, v in state["momentum"].items()}
    return ({k: p - lr * vel[k] for k, p in params.items()},
            {"momentum": vel})


def adam_init(params):
    return {"step": torch.zeros((), dtype=torch.int32),
            "m": {k: torch.zeros_like(p) for k, p in params.items()},
            "v": {k: torch.zeros_like(p) for k, p in params.items()}}


def adam_step(params, grads, state, lr: float, beta_1: float = 0.9,
              beta_2: float = 0.999, epsilon: float = 1e-8):
    """autodiff.py::Adam.step — bias-corrected Adam."""
    t = state["step"] + 1
    m = {k: beta_1 * m_ + (1 - beta_1) * grads[k]
         for k, m_ in state["m"].items()}
    v = {k: beta_2 * v_ + (1 - beta_2) * grads[k] * grads[k]
         for k, v_ in state["v"].items()}
    tf = t.to(torch.float32)
    lr_t = lr * torch.sqrt(1 - beta_2 ** tf) / (1 - beta_1 ** tf)
    new = {k: p - lr_t * m[k] / (torch.sqrt(v[k]) + epsilon)
           for k, p in params.items()}
    return new, {"step": t, "m": m, "v": v}


# --- stateful wrappers (the reference's script-facing API) ------------------

class Optimizer:
    def __init__(self, params: Dict, lr: float):
        self.params = dict(params)
        self.lr = lr
        self.state = self._init(self.params)

    def step(self, grads: Dict) -> Dict:
        self.params, self.state = self._step(self.params, grads, self.state)
        return self.params

    def __getitem__(self, k):
        return self.params[k]

    def __setitem__(self, k, v):
        self.params[k] = torch.as_tensor(v)


class SGD(Optimizer):
    def __init__(self, params, lr, momentum: float = 0.0):
        self.momentum = momentum
        super().__init__(params, lr)

    def _init(self, params):
        return sgd_init(params)

    def _step(self, params, grads, state):
        return sgd_step(params, grads, state, self.lr, self.momentum)


class Adam(Optimizer):
    def __init__(self, params, lr, beta_1: float = 0.9, beta_2: float = 0.999,
                 epsilon: float = 1e-8):
        self.beta_1, self.beta_2, self.epsilon = beta_1, beta_2, epsilon
        super().__init__(params, lr)

    def _init(self, params):
        return adam_init(params)

    def _step(self, params, grads, state):
        return adam_step(params, grads, state, self.lr, self.beta_1,
                         self.beta_2, self.epsilon)
