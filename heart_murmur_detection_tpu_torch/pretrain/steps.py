"""The optimizer of continued pretraining — counterpart of
heart_murmur_detection_tpu/pretrain/steps.py (`adam_with_epoch_decay`,
`make_frozen`).

Adam (betas 0.9 / 0.999, eps 1e-8, no weight decay) whose learning rate is
lr * decay ** (step // steps_per_epoch), with step the number of updates
already made (0 for the first, as optax counts), so it falls x0.99 at each
epoch boundary (DecayLearningRate). torch.optim.Adam's update
lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps) is optax's
scale_by_adam followed by scale_by_learning_rate.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch


class EpochDecayAdam:
    """torch.optim.Adam with the per-epoch learning-rate decay."""

    def __init__(self, params: Iterable[torch.Tensor], steps_per_epoch: int,
                 lr: float = 1e-4, decay: float = 0.99):
        self.opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.steps_per_epoch = max(int(steps_per_epoch), 1)
        self.lr, self.decay = lr, decay
        self.count = 0  # updates made

    def current_lr(self) -> float:
        return self.lr * self.decay ** (self.count // self.steps_per_epoch)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        for group in self.opt.param_groups:
            group["lr"] = self.current_lr()
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adam": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["adam"])
        self.count = int(state["count"])


def adam_with_epoch_decay(params: Iterable[torch.Tensor], steps_per_epoch: int,
                          lr: float = 1e-4, decay: float = 0.99) -> EpochDecayAdam:
    """Adam whose LR decays x`decay` at each epoch boundary."""
    return EpochDecayAdam(params, steps_per_epoch, lr, decay)


def make_frozen(model: torch.nn.Module,
                trainable_fn: Optional[Callable[[str], bool]] = None) -> List[torch.Tensor]:
    """The parameters the optimizer updates: those whose state_dict name
    trainable_fn accepts (all without one). Frozen parameters get no update
    (optax.set_to_zero); buffers such as bn0's running statistics are not
    parameters and go on updating in the train step."""
    return [p for name, p in model.named_parameters()
            if trainable_fn is None or trainable_fn(name)]
