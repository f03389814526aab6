"""PANNs Cnn14, the CLAP-2022 audio backbone — counterpart of
heart_murmur_detection_tpu/models/cnn14.py (`ConvBlock` :15, `Cnn14` :32;
the reference's msclap/models/audio.py:132).

log-mel (B, T, 64) -> bn0 over the mel bins -> six conv blocks (each two
3x3 convolutions without bias + BatchNorm + ReLU, the flax SAME padding as
padding=1, then a 2x2 average pool that floors odd sizes: 690 frames ->
345 -> ... -> 10), 64 -> 2048 channels -> the mean over frequency -> the
max plus the mean over the valid time steps (ceil(n_frames / 64), clipped
to [1, T'], the max over a -1e30 fill) -> fc1 + ReLU = the (B, 2048)
embedding. The BatchNorms run on their running statistics, or in train
mode with flax semantics (momentum 0.9, models/bn.py) when the caller
passes a stats dict, as CLAP-2022 fine-tuning does. On a tensor axis
(parallel/tensor.py::shard_model: fc1 column-parallel, the JAX rule) fc1
runs on the rank's columns and its ReLU output is all-gathered over the
model axis (`tensor.gather`) before fc_audioset. Module names are msclap's
(bn0, conv_block{i}.conv{j} / bn{j}, fc1, fc_audioset), so an msclap
state_dict loads by name (extract/convert.py::load_clap_ckpt).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tensor
from .bn import Stats, batch_norm

CHANNELS = (64, 128, 256, 512, 1024, 2048)
BN_MOMENTUM = 0.9  # flax


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_ch, eps=1e-5)
        self.bn2 = nn.BatchNorm2d(out_ch, eps=1e-5)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        x = F.relu(batch_norm(self.bn1, self.conv1(x), BN_MOMENTUM, stats))
        x = F.relu(batch_norm(self.bn2, self.conv2(x), BN_MOMENTUM, stats))
        return F.avg_pool2d(x, 2)


class Cnn14(nn.Module):
    """log-mel (B, T, mel_bins) [+ valid frame counts] -> dict(embedding
    (B, 2048), clipwise_output (B, classes_num)): forward on the running
    statistics without gradients, forward_train with them and a stats dict
    for train mode (models/bn.py)."""

    def __init__(self, classes_num: int = 527, mel_bins: int = 64):
        super().__init__()
        self.bn0 = nn.BatchNorm2d(mel_bins, eps=1e-5)
        ins = (1,) + CHANNELS[:-1]
        for i, (a, b) in enumerate(zip(ins, CHANNELS)):
            setattr(self, f"conv_block{i + 1}", ConvBlock(a, b))
        self.fc1 = nn.Linear(CHANNELS[-1], CHANNELS[-1])
        self.fc_audioset = nn.Linear(CHANNELS[-1], classes_num)

    @torch.no_grad()
    def forward(self, logmel: torch.Tensor, n_frames: Optional[torch.Tensor] = None) -> dict:
        return self.forward_train(logmel, n_frames, None)

    def forward_train(self, logmel: torch.Tensor, n_frames: Optional[torch.Tensor],
                      stats: Optional[Stats]) -> dict:
        """The forward with gradients: train mode with a stats dict."""
        x = batch_norm(self.bn0, logmel.transpose(1, 2)[..., None], BN_MOMENTUM,
                       stats)  # bins as channels
        x = x[..., 0].transpose(1, 2)[:, None]  # (B, 1, T, F)
        for i in range(len(CHANNELS)):
            x = getattr(self, f"conv_block{i + 1}")(x, stats)
        x = x.mean(dim=3).transpose(1, 2)  # frequency mean -> (B, T', C)
        if n_frames is not None:
            tmax = x.shape[1]
            valid = torch.ceil(n_frames.to(torch.float32) / 64.0).to(torch.int64)  # 6 pools of 2
            ok = (torch.arange(tmax, device=x.device)[None, :]
                  < torch.clamp(valid, 1, tmax)[:, None])[..., None]
            xmax = torch.where(ok, x, torch.full_like(x, -1e30)).amax(dim=1)
            xmean = torch.where(ok, x, 0.0).sum(dim=1) / torch.clamp(
                ok.sum(dim=1), min=1).to(x.dtype)
        else:
            xmax, xmean = x.amax(dim=1), x.mean(dim=1)
        if tensor.sharded(self.fc1):  # column-parallel over a tensor axis
            x = tensor.column_in(xmax + xmean, self.fc1)
            h = F.relu(F.linear(x, self.fc1.weight, tensor.local(self.fc1.bias)))
            h = tensor.gather(h, tensor.placement(self.fc1.weight).mesh)
        else:
            h = F.relu(self.fc1(xmax + xmean))
        return {"embedding": h, "clipwise_output": torch.sigmoid(self.fc_audioset(h))}
