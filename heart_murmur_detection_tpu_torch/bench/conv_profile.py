"""Device profiles of the port's three convolutional towers, which run on
cuDNN (no kernel of the repository): the EfficientNet-B0 of operaCE, VGGish
and CLAP-2022's Cnn14; and of one COLA training step of the EfficientNet.

    python -m heart_murmur_detection_tpu_torch.bench.conv_profile [tag]

Each tower is profiled in a fresh child process (the card machine's profiler
drops device records once a process has lived some tens of seconds), on one
batch of its extraction path in strict float32 (TF32 off), random weights
from seed 0, inputs already on the card:
  efficientnet: FeatureExtractor("operaCE")'s batch function (int16 wire
                decode, the log-mel frontend, the EfficientNet with masked
                pooling) on B=16 clips of 32 s (1001 mel frames);
  vggish:       the network on B=64 log-mel examples (96 x 64);
  cnn14:        CLAPAudioEncoder("2022") (the 44.1 kHz frontend, the Cnn14,
                the projection) on B=16 clips of 5 s;
  efficientnet_cola_step: pretrain/cola_training.py::train_step in bf16
                (cli.pretrain compute_dtype=bfloat16: the pair forward with
                train-mode BatchNorms, drop-connect and dropout, backward,
                Adam) on B=16 pairs of 251 frames.
Each child prints one JSON line: the batch's CUDA-event time unprofiled
(wall_ms, 5 batches after 2 of warm-up), the device time by kernel family
(convolutions by cuDNN's algorithm family, the GEMMs, everything else as
glue), the top kernels by name, and the idle share 1 - device busy / wall.
The parent prints one line a tower, prefixed by `tag`. Needs a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

from .hear_rate import _device_rows
from .tower_rate import _ms

TOWERS = ("efficientnet", "vggish", "cnn14", "efficientnet_cola_step")
# (family, substrings of a lower-cased kernel name), first match wins
FAMILIES = (
    ("conv depthwise", ("depthwise", "dwconv", "grouped_direct")),
    ("conv dgrad / wgrad", ("dgrad", "wgrad")),
    ("conv winograd", ("winograd",)),
    ("conv fft", ("fft",)),
    ("conv implicit gemm", ("implicit", "fprop", "convolve", "conv2d", "conv_")),
    ("gemm", ("gemm", "cutlass", "gemv")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "glue"


def setup(tower: str):
    """The batch function of a tower on the card (a no-argument callable)."""
    from ..utils.precision import strict_f32

    g = torch.Generator().manual_seed(2)
    if tower == "efficientnet":
        from ..extract.extract import FeatureExtractor

        ex = FeatureExtractor("operaCE", random_init=True, seed=0, device="cuda")
        n = 32 * 16000
        wav = (torch.randn(16, n, generator=g) * 3000).to(torch.int16).cuda()
        lengths = torch.full((16,), n, dtype=torch.int32, device="cuda")
        fn = ex._build()
        return lambda: fn(wav, lengths)
    if tower == "vggish":
        from ..models.vggish import VGGish, init_weights

        model = init_weights(VGGish(), torch.Generator().manual_seed(0)).cuda().eval()
        x = torch.randn(64, 96, 64, generator=g).cuda()

        def run():
            with torch.no_grad(), strict_f32():
                return model(x)

        return run
    from ..extract.registry import initialize_pretrained_model

    if tower == "efficientnet_cola_step":
        from ..pretrain import cola_training as ct
        from ..pretrain import steps

        model = initialize_pretrained_model("operaCE", random_init=True, seed=0).cuda().train()
        opt = steps.adam_with_epoch_decay(list(model.parameters()), 5)
        gen = torch.Generator(device="cuda").manual_seed(0)
        x1, x2 = (torch.randn(16, 251, 64, generator=g).cuda() for _ in range(2))
        return lambda: ct.train_step(model, opt, x1, x2, gen, torch.bfloat16, "autograd", 0.1)
    model = initialize_pretrained_model("clap", random_init=True, seed=0).cuda()
    n = model.config.n_samples
    wav = (torch.randn(16, n, generator=g) * 0.1).cuda()
    lengths = torch.full((16,), n, dtype=torch.int32, device="cuda")

    def run():
        with strict_f32():
            return model(wav, lengths)

    return run


def profile_child(tower: str) -> int:
    fn = setup(tower)  # each eval batch function runs without gradients itself
    wall = _ms(fn, 5, 2)
    rows = _device_rows(fn)
    busy = sum(rows.values())
    fams = {}
    for name, ms in rows.items():
        fams[family(name)] = fams.get(family(name), 0.0) + ms
    top = sorted(rows.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({"tower": tower, "wall_ms": round(wall, 4), "device_busy_ms": round(busy, 4),
                      "idle_share": round(1 - busy / wall, 4),
                      "families_ms": {k: round(v, 4) for k, v in sorted(fams.items())},
                      "top_kernels_ms": [[k[:120], round(v, 4)] for k, v in top]}))
    return 0


def profile(tower: str) -> dict:
    """profile_child's reading for one tower, from a fresh process."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    child = subprocess.run([sys.executable, "-m", __spec__.name, "--profile-child", tower],
                           capture_output=True, text=True, cwd=root)
    lines = child.stdout.strip().splitlines()
    if child.returncode or not lines:
        raise RuntimeError(f"conv_profile {tower} child failed: {child.stderr[-2000:]}")
    return json.loads(lines[-1])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("conv_profile: needs a CUDA card", file=sys.stderr)
        return 1
    if argv[:1] == ["--profile-child"]:
        return profile_child(argv[1])
    tag = argv[0] if argv else "conv_profile"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for tower in TOWERS:
        print(tag, json.dumps({"card": smi, **profile(tower)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
