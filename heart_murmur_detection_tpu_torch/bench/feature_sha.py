"""The bits of the operaCT feature path, to compare two source trees:

    python -m heart_murmur_detection_tpu_torch.bench.feature_sha [tag]

Random operaCT weights from seed 0 (models/htsat.py::init_weights), 16 mel
clips of 251 frames (four of them shorter, by their frame counts) from a
seeded generator, models/htsat_fused.py::htsat_apply_fused in the bf16 flow
on the kernels, twice. Prints one JSON line, prefixed by `tag`: the SHA-1 of
the latent's bytes, whether the two runs agree bit for bit, and the swin
kernels' launches of one forward. Run it from each tree (copy the module
into an older tree's bench/); equal hashes mean the same feature bits.
Needs a card.
"""

from __future__ import annotations

import hashlib
import json
import sys

import torch

from ..models.cola import Cola
from ..models.htsat import init_weights
from ..ops import swin


def main(tag: str = "") -> dict:
    model = Cola()
    init_weights(model, torch.Generator().manual_seed(0))
    enc = model.htsat.cuda().eval()
    g = torch.Generator().manual_seed(18)
    mel = torch.rand(16, 251, 64, generator=g).cuda()
    n_frames = torch.tensor([251] * 12 + [200, 150, 90, 40], dtype=torch.int32).cuda()
    swin.reset_launch_counts()
    out = enc(mel, n_frames, mm_dtype=torch.bfloat16)
    counts = swin.launch_counts()
    again = enc(mel, n_frames, mm_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    row = {"tag": tag, "sha1": hashlib.sha1(out.float().cpu().numpy().tobytes()).hexdigest(),
           "repeatable": bool(torch.equal(out, again)),
           "launches": {k: counts[k] for k in ("swin_attn", "swin_mlp")}}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main(*sys.argv[1:2])
