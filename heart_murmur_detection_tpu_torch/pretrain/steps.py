"""The optimizer and the MAE steps of continued pretraining — counterpart
of heart_murmur_detection_tpu/pretrain/steps.py (`adam_with_epoch_decay`,
`make_frozen`, `make_mae_train_step` :82, `make_mae_eval_step` :109; the
COLA step lives in cola_training.py).

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

from ..models.mae_train_fused import mae_train_loss_fused


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


def mae_train_step(model: torch.nn.Module, opt: EpochDecayAdam, x: torch.Tensor,
                   mm_dtype: torch.dtype, impl: str,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One MAE CP step: the masked-patch loss of batch x (B, T, F) with the
    encoder on the training blocks (impl as ops.vit_train), backward, Adam.
    Masking noise (B, L) as given, else drawn from `generator`."""
    opt.zero_grad()
    loss = mae_train_loss_fused(model, x, noise, generator, mm_dtype, impl)
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def mae_eval_step(model: torch.nn.Module, x: torch.Tensor, mm_dtype: torch.dtype, impl: str,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The same loss without gradients; the encoder runs the eval blocks of
    ops.vit (the kernels on a card, stable softmax)."""
    return mae_train_loss_fused(model, x, noise, generator, mm_dtype, impl, train=False)
