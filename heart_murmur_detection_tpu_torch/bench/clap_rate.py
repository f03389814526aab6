"""Device-resident throughput of the CLAP-2023 tower (HTS-AT at 44.1 kHz on
the swin kernels), and a profile of one batch.

    python -m heart_murmur_detection_tpu_torch.bench.clap_rate [tag] [repeats] [--profile]

Random weights from seed 0 (the registry's random_init), B=16 clips of 7 s
of noise at 44.1 kHz (308 700 samples, the extractor's stacked width)
already on the card as float32 waveforms, the extraction flow of
models/clap.py::clap_audio_forward_fused (the 44.1 kHz log-mel frontend in
float32, bn0, the bicubic resize to 1024 frames, the 12 swin blocks on
swin_attn / swin_mlp, fast softmax, the projection), timed as
bench/hear_rate.py times HeAR: CUDA events over 10 batches of the kernel
path and 3 of the plain bf16 path (the kernels' plain versions), in turns
(kernel, plain, plain, kernel), `repeats` times (default 1). Prints one
JSON line of ms a batch and clips a second, prefixed by `tag`. With --profile, a fresh child process
(the card machine's profiler drops device records once a process has lived
some tens of seconds) prints one JSON line: the device ms of one batch by
kernel, the frontend (the framing, the two DFT products, the mel product
and the log, each alone and whole), the glue (the rest: bn0, the resize,
patch embed and merges, pads, the final LayerNorm, the projection) and the
idle share against the unprofiled batch. Needs a card.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from . import hear_rate
from .hear_rate import _device_rows, rates
from .tower_rate import _ms

B = 16
KERNELS = (("swin_attn", "swin_attn_kernel"), ("swin_mlp", "swin_mlp_kernel"))


def setup(batch: int = B, seed: int = 0):
    """(the model, (batch, 308700) float32 waveforms on the card, their
    lengths, the kernel path's batch function, the plain bf16 path's)."""
    from ..extract.registry import initialize_pretrained_model
    from ..models.clap import CLAPConfig, clap_audio_forward_fused

    model = initialize_pretrained_model("clap2023", random_init=True, seed=seed).cuda()
    n = int(CLAPConfig(version="2023").duration * 44100)
    g = torch.Generator().manual_seed(seed + 2)
    wav = (torch.randn(batch, n, generator=g) * 0.1).cuda()
    lengths = torch.full((batch,), n, dtype=torch.int32, device="cuda")
    kern = lambda: clap_audio_forward_fused(model, wav, lengths, torch.bfloat16, True)
    plain = lambda: clap_audio_forward_fused(model, wav, lengths, torch.bfloat16, True,
                                             impl="plain")
    return model, wav, lengths, kern, plain


def profile_child() -> int:
    """The child: one JSON line of one kernel-path batch's device time."""
    from ..audio import dsp

    model, wav, lengths, kern, _ = setup()
    cfg = model.config
    with torch.no_grad():
        wall = _ms(kern, 5, 2)
        rows = _device_rows(kern)
        kernels = {k: sum(v for key, v in rows.items() if sym in key) for k, sym in KERNELS}
        busy = sum(rows.values())
        # the frontend's steps, each alone on the batch's own intermediates
        pad = cfg.n_fft // 2
        x = torch.nn.functional.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
        T = wav.shape[1] // cfg.hop + 1
        frames = dsp.frame_signal(x, cfg.n_fft, cfg.hop, T)
        cos, sin, fb = dsp._device_constants(wav.device, cfg.sample_rate, cfg.n_fft,
                                             cfg.mel_bins, cfg.fmin, cfg.fmax)
        re, im = frames @ cos, frames @ sin
        power = re * re + im * im
        steps = {"framing": lambda: dsp.frame_signal(
                     torch.nn.functional.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0],
                     cfg.n_fft, cfg.hop, T),
                 "dft": lambda: (frames @ cos, frames @ sin),
                 "mel_log": lambda: torch.log10(torch.clamp(power @ fb, min=1e-10)),
                 "frontend_whole": lambda: model.logmel(wav, lengths)}
        front = {k: round(sum(_device_rows(fn).values()), 4) for k, fn in steps.items()}
    glue = busy - sum(kernels.values()) - front["frontend_whole"]
    print(json.dumps({"batch": B, "wall_ms": round(wall, 4), "device_busy_ms": round(busy, 4),
                      "idle_share": round(1 - busy / wall, 4),
                      "kernels_ms": {k: round(v, 4) for k, v in kernels.items()},
                      "frontend_ms": front, "glue_ms": round(glue, 4)}))
    return 0


def profile_in_child() -> dict:
    """profile_child's reading, from a fresh process."""
    return hear_rate.profile_in_child(__spec__.name)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("clap_rate: needs a CUDA card", file=sys.stderr)
        return 1
    if argv[:1] == ["--profile-child"]:
        return profile_child()
    want_profile = "--profile" in argv
    argv = [a for a in argv if a != "--profile"]
    tag = argv[0] if argv else "clap_rate"
    repeats = int(argv[1]) if len(argv) > 1 else 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    *_, kern, plain = setup()
    with torch.no_grad():
        out = {"card": smi, **rates(kern, plain, repeats, B)}
    print(tag, json.dumps(out), flush=True)
    if want_profile:
        print(tag, "profile:", json.dumps(profile_in_child()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
