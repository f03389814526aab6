"""The optimizer and the MAE steps of continued pretraining — counterpart
of heart_murmur_detection_tpu/pretrain/steps.py (`adam_with_epoch_decay`,
`make_frozen`, `make_mae_train_step` :82, `make_mae_eval_step` :109; the
COLA step lives in cola_training.py), with the data-parallel pieces the
trainers share (parallel/mesh.py).

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
from ..parallel import tensor
from ..parallel.mesh import (ZeroShard, all_reduce_grads, all_reduce_sum, data_size,
                             gather_objects, place_like)


class EpochDecayAdam:
    """torch.optim.Adam with the per-epoch learning-rate decay."""

    def __init__(self, params: Iterable[torch.Tensor], steps_per_epoch: int,
                 lr: float = 1e-4, decay: float = 0.99):
        self.params = list(params)
        self.opt = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
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


def full_opt_state(opt: EpochDecayAdam, zero: Optional[ZeroShard] = None) -> dict:
    """The optimizer state a resume checkpoint holds: under ZeRO-3 or the
    tensor axis gathered to full size first (every rank takes part)."""
    sd = opt.state_dict()
    if zero is not None:
        return {**sd, "adam": zero.full_state(sd["adam"])}
    return {**sd, "adam": tensor.full_adam_state(opt.params, sd["adam"])}


def load_train_state(model: torch.nn.Module, opt: EpochDecayAdam, zero: Optional[ZeroShard],
                     state_dict: dict, opt_state: dict) -> None:
    """Restore a resume checkpoint: the weights placed as the run set them
    up (parallel/mesh.py::place_like; the tensor axis's parts of them,
    parallel/tensor.py) and, under ZeRO-3 or the tensor axis, the full-size
    optimizer state re-sharded for this rank."""
    if zero is not None:
        zero.gather()
    tensor.load_state_dict(model, place_like(model.state_dict(), state_dict))
    if zero is not None:
        zero.load_params()
        zero.release()
        opt_state = {**opt_state, "adam": zero.shard_state(opt_state["adam"])}
    else:
        opt_state = {**opt_state, "adam": tensor.shard_adam_state(opt.params, opt_state["adam"])}
    opt.load_state_dict(opt_state)


def rng_state(sampler, gen: torch.Generator, mesh) -> dict:
    """The run's random state at an epoch's end, for a resume checkpoint:
    the sampler's and every rank's generator (every rank takes part)."""
    return {"sampler": sampler.state_dict(), "generators": gather_objects(gen.get_state(), mesh)}


def restore_rng(extra: dict, sampler, gen: torch.Generator, mesh) -> None:
    """Put a resumed run's sampler and generator where the saved run left
    them, so it draws on as the uninterrupted run would (a checkpoint from
    another world size keeps the sampler and the reseeded generator)."""
    if "sampler" not in extra:
        return
    sampler.load_state_dict(extra["sampler"])
    gens = extra["generators"]
    if len(gens) == (1 if mesh is None else mesh.world):
        gen.set_state(gens[0 if mesh is None else mesh.rank])


def reduce_grads(opt: EpochDecayAdam, mesh, zero: Optional[ZeroShard]) -> None:
    """Complete a data-parallel step's gradients: ZeRO-3 reduces the shares
    into opt's shard and frees the gathered model; otherwise the gradients
    of parameters used as a slice on the tensor axis are summed over it,
    then every gradient over the data axis (one all-reduce each)."""
    if zero is not None:
        zero.reduce_grads()
        zero.release()
    elif mesh is not None:
        tensor.reduce_slices(opt.params)
        all_reduce_grads(opt.params, mesh)


def mae_train_step(model: torch.nn.Module, opt: EpochDecayAdam, x: torch.Tensor,
                   mm_dtype: torch.dtype, impl: str,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   mesh=None, zero: Optional[ZeroShard] = None) -> torch.Tensor:
    """One MAE CP step: the masked-patch loss of batch x (B, T, F) with the
    encoder on the training blocks (impl as ops.vit_train), backward, Adam.
    Masking noise (B, L) as given, else drawn from `generator`.

    mesh: x and noise are this rank's rows of the global batch; the rank's
    loss share is its masked mean over n, the data axis's length (exact:
    equal shard sizes, and len_keep is static), the shares' gradients are
    summed (reduce_grads), and the global loss is returned. zero: ZeRO-3
    (the model is gathered for the step)."""
    opt.zero_grad()
    if zero is not None:
        zero.gather()
    loss = mae_train_loss_fused(model, x, noise, generator, mm_dtype, impl)
    n = data_size(mesh)
    (loss / n).backward()
    reduce_grads(opt, mesh, zero)
    opt.step()
    loss = loss.detach()
    return loss if mesh is None else all_reduce_sum(loss, mesh) / n


@torch.no_grad()
def mae_eval_step(model: torch.nn.Module, x: torch.Tensor, mm_dtype: torch.dtype, impl: str,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  mesh=None) -> torch.Tensor:
    """The same loss without gradients; the encoder runs the eval blocks of
    ops.vit (the kernels on a card, stable softmax). mesh: this rank's rows,
    the global batch's loss returned."""
    loss = mae_train_loss_fused(model, x, noise, generator, mm_dtype, impl, train=False)
    return loss if mesh is None else all_reduce_sum(loss, mesh) / data_size(mesh)
