"""How far the float32 ViT kernels and their plain float32 versions each sit
from the same function evaluated in float64, at the towers' shapes.

    python -m heart_murmur_detection_tpu_torch.bench.vit_f32_error [tag]

For each shape of chip_smoke.py's phase 37 (the MAE CP steps at B = 64,
fine-tuning at B = 16) and two scales of the qkv weights (x 2, the phase's,
and x 1), one random block (0.05-scale weights, x 0.5, dy 0.1, its padded
rows 0) and one JSON line a function: the MLP half (vit_mlp_f32), the
attention half (vit_qkv_f32, vit_attn_f32, vit_proj_f32 in turn), dh1 of the
MLP backward (vit_mlp_bwd_f32) and dx of the attention backward
(vit_attn_bwd_f32); for each the largest and root-mean-square entry of the
float64 result and the largest |kernel - plain float32|, |kernel - float64|
and |plain float32 - float64|. The float64 evaluation is torch's layer_norm,
matmuls, softmax and GELU in float64 on the same float32 inputs and weights
(torch autograd for the backward halves); TF32 is off. The card's name and
power limit come first.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..ops import vit
from ..ops import vit_train as vt

# (tag, C, heads, Np, n_real, B): chip_smoke.py's F32_VIT_SHAPES
SHAPES = (("mae cp", 384, 6, 320, 308, 64), ("audiomae cp", 768, 12, 160, 154, 64),
          ("operaGT ft", 384, 6, 1040, 1025, 16), ("audiomae ft", 768, 12, 528, 513, 16))


def params(C: int, heads: int, dev, seed: int, qk: float) -> vit.VitBlockParams:
    """A random block in the float32 layout, the qkv weights x qk."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    f = lambda *sh: torch.randn(*sh, generator=g) * 0.05
    sd = {"norm1.weight": 1 + f(C), "norm1.bias": f(C), "attn.qkv.weight": f(3 * C, C) * qk,
          "attn.qkv.bias": f(3 * C), "attn.proj.weight": f(C, C), "attn.proj.bias": f(C),
          "norm2.weight": 1 + f(C), "norm2.bias": f(C), "mlp.fc1.weight": f(4 * C, C),
          "mlp.fc1.bias": f(4 * C), "mlp.fc2.weight": f(C, 4 * C), "mlp.fc2.bias": f(C)}
    return vit.prep_vit_block(sd, heads, torch.float32, dev)


def attn64(x: torch.Tensor, p: vit.VitBlockParams, n_real: int) -> torch.Tensor:
    """The attention half in float64 (x float64)."""
    d = lambda t: t.double()
    B, Np, C = x.shape
    h = F.layer_norm(x, (C,), d(p.ln1_w), d(p.ln1_b), vit.LN_EPS)
    qkv = (h @ d(p.w_qkv).T + d(p.b_qkv)).reshape(B, Np, 3, p.heads, vit.HD).permute(2, 0, 3, 1, 4)
    s = qkv[0] @ qkv[1].transpose(-1, -2)
    s = s.masked_fill(torch.arange(Np, device=x.device) >= n_real, vit.MASK)
    o = (torch.softmax(s, -1) @ qkv[2]).permute(0, 2, 1, 3).reshape(B, Np, C)
    return x + o @ d(p.w_proj).T + d(p.b_proj)


def mlp64(h1: torch.Tensor, p: vit.VitBlockParams) -> torch.Tensor:
    """The MLP half in float64 (h1 float64)."""
    d = lambda t: t.double()
    m = F.layer_norm(h1, (h1.shape[-1],), d(p.ln2_w), d(p.ln2_b), vit.LN_EPS)
    return h1 + F.gelu(m @ d(p.w_fc1).T + d(p.b_fc1)) @ d(p.w_fc2).T + d(p.b_fc2)


def line(tag: str, what: str, k: torch.Tensor, p32: torch.Tensor, r64: torch.Tensor) -> dict:
    k, p32 = k.double(), p32.double()
    mx = lambda t: float(t.abs().max())
    return {"tag": tag, "function": what, "max_ref": mx(r64),
            "rms_ref": float(r64.pow(2).mean().sqrt()), "kernel_vs_plain": mx(k - p32),
            "kernel_vs_f64": mx(k - r64), "plain_vs_f64": mx(p32 - r64)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tag = argv[0] if argv else "run"
    if not torch.cuda.is_available():
        print("vit_f32_error: needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    for shape, C, heads, Np, n_real, B in SHAPES:
        for qk in (2.0, 1.0):
            name = f"{tag} {shape} B={B} Np={Np} C={C} qkv x{qk:g}"
            g = torch.Generator(device="cpu").manual_seed(41 + Np)
            p = params(C, heads, dev, 40 + Np, qk)
            x = (torch.randn(B, Np, C, generator=g) * 0.5).to(dev)
            dy = (torch.randn(B, Np, C, generator=g) * 0.1).to(dev)
            dy[:, n_real:] = 0
            h1 = vit.vit_attn_ref(x, p, n_real)
            rows = [line(name, "vit_mlp_f32", vit.vit_mlp_f32(h1, p), vit.vit_mlp_ref(h1, p),
                         mlp64(h1.double(), p)),
                    line(name, "attention half", vit.vit_proj_f32(
                        vit.vit_attn_f32(vit.vit_qkv_f32(x, p), p, n_real), x, p), h1,
                         attn64(x.double(), p, n_real))]
            hd = h1.double().requires_grad_()
            (dh1_64,) = torch.autograd.grad(mlp64(hd, p), hd, dy.double())
            rows.append(line(name, "vit_mlp_bwd_f32 dh1", vt.vit_mlp_bwd_f32(h1, dy, p)[0],
                             vt.vit_mlp_bwd_ref(h1, dy, p)[0], dh1_64))
            dh1 = vt.vit_mlp_bwd_ref(h1, dy, p)[0]
            xd = x.double().requires_grad_()
            (dx_64,) = torch.autograd.grad(attn64(xd, p, n_real), xd, dh1.double())
            rows.append(line(name, "vit_attn_bwd_f32 dx", vt.vit_attn_bwd_f32(x, dh1, p, n_real)[0],
                             vt.vit_attn_bwd_ref(x, dh1, p, n_real)[0], dx_64))
            for r in rows:
                print(json.dumps(r), flush=True)
            del h1, dh1, hd, xd, rows
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
