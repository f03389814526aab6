#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (heart_murmur_detection_tpu_torch).

    python3 chip_smoke.py        # from the repo root, on a machine with one NVIDIA H100

Phases (each prints one line; any failure exits non-zero):
  1. card: nvidia-smi name and power limit, torch and CUDA versions
  2. build: the CUDA kernels from csrc/ with nvcc (seconds, ptxas summary)
  3. kernels vs plain: each kernel against its plain torch version on the
     same bf16 inputs at the four stage geometries (B=16), compared on the
     branch (out - x), with times
  4. serving: a random-init full-width operaCT server answers /healthz and
     /extract (JSON paths, raw WAV bytes) on 20 WAVs of 6-32 s; served ==
     offline; launch counters show 12 swin_attn + 12 swin_mlp per batch
  5. numerics: served features against the port's plain paths on the card;
     operaCT dim=512 (the reference's float32 graph: no swin launch)
     against the same graph on the CPU
  6. throughput: device-resident 10-s clips at B=64, kernel path and plain
  7. train kernels vs plain: at the stage 0-2 geometries and the CP batch
     (B=64), the forward halves with DropPath multipliers (a 0 and a 1/0.9
     among them) and both backward halves, each against its plain version
     (cosine of each branch, dx / dh1 branch and every gradient leaf >=
     0.99999), two launches bitwise equal; the weight-gradient products
     (one swin_wgrad launch each, its chunk partials summed in order inside)
     against torch.mm and the column-sum reductions (swin_reduce, bitwise
     the in-order sum) at the step's shapes, a line a (S, L) against
     sum(0); times per launch, each backward half's library chain
     (bench/swin_bwd_time.py: the autograd backward of its library calls
     in bf16) and the device time of each grid launch of a backward call
     by kernel name (torch.profiler)
  8. CP: three synthetic corpora (circor, physionet16, pascal_A; 300 clips
     of 260-1000 frames each) on disk, one epoch of COLA continued
     pretraining of the full-width operaCT at B=64 through cli.pretrain on
     the train kernels (20 launches of each backward kernel a step), and
     the same through the plain bf16 path; then 3 steps of each path from
     the same weights, batches and dropout / DropPath generator: losses
     within 1e-3 relative, step-0 gradient leaves against each other and
     strict f32 (the gradient rule below); steady-state step times and a
     profile of one step
  9. ViT kernels vs plain: vit_qkv, vit_attn (the attention core), vit_proj
     and vit_mlp against their plain versions at the operaGT (B=16, 1040
     tokens, C 384, 6 heads) and Audio-MAE (B=16, 528 tokens, C 768, 12
     heads) shapes, padded keys masked (n_real < Np), both softmax modes:
     cosine of each output (qkv and vit_qkv's LN1 output, o_pre) or branch
     (out - x; vit_attn then vit_proj against the plain attention half) >=
     0.99999, two launches bitwise equal, with times, the bound and the
     library call's time (SDPA for the core, torch.addmm plus the residual
     for proj)
 10. operaGT served: a random-init full-width operaGT server answers
     /healthz and /extract on the same 20 WAVs (clips over 8.18 s split into
     several chunks); served == offline; 12 vit_qkv + 12 vit_attn + 12
     vit_proj + 12 vit_mlp launches per batch
 11. audiomae: offline extraction of the same WAVs (10 s chunks), 12
     launches of each ViT kernel per batch
 12. numerics, both towers: features against the plain bf16 flow (>=
     0.99999) and the strict f32 path, TF32 off (>= 0.99995)
 13. throughput, both towers: device-resident chunks/s, kernel path (both
     softmax modes) and plain bf16 path (operaGT B=64 of 8.18-s chunks,
     audiomae B=32 of 10-s chunks), and a profile of one batch: each kernel,
     the glue and the idle share
 14. ViT train kernels vs plain: vit_mlp_bwd (csrc/swin_mlp_bwd.cu, LN eps
     1e-6) and vit_attn_bwd (csrc/vit_attn_bwd.cu) against their plain
     versions at the CP shapes (Audio-MAE B=64, 160 tokens / 154 real, C 768;
     OPERA-GT B=64, 320 / 308 and 80 / 77, C 384) and once at the operaGT
     fine-tuning shape (B=4, 1040 / 1025): the dx / dh1 branch, every operand
     row (dq, dk and dv apart) and every gradient leaf >= 0.99999, two
     launches bitwise equal, padded rows of the input gradient and the dk /
     dv rows of the padded keys exactly 0; fused_vit_block_train against
     impl="plain" (output branch and every leaf); times a launch, the plain
     halves, the bound of K9's backward function, SDPA's backward on the same
     q, k, v, dO, vit_attn_bwd's function as a chain of library calls,
     vit_mlp_bwd's as the autograd backward of its library chain, and the
     device time of each grid launch of both calls by kernel name
     (torch.profiler); at the Audio-MAE shape, the step's weight
     products against torch.mm and its column sums, a line a (S, L),
     swin_reduce against sum(0)
 15. Audio-MAE CP: three synthetic heart corpora (fbank clips of 600-1400
     frames x 128) on disk, one epoch of method=audiomae at B=64 through
     cli.pretrain on the kernels (12 launches of each backward kernel a
     step) and on the plain bf16 path; steady-state step times
 16. MAE (OPERA-GT) CP: two synthetic respiratory corpora at max_len 256 and
     64, one epoch of method=mae on the kernels, both lengths drawn
 17. Audio-MAE agreement: 3 steps of the kernel path and of the plain bf16
     path from the same weights, batches and masking noise (losses within
     1e-3, the step-0 gradient rule); a profile of one step: each kernel,
     the plain-torch decoder, the glue, the optimizer and the idle share
 18. logmel vs plain: the fused log-mel kernel (csrc/logmel.cu, TPU K4)
     against its plain version at the operaCT serving (B=16) and throughput
     (B=64) batches of 10-s clips, cli.process's B=16 of 32-s clips, the
     operaGT chunk batch (B=64 of 8.18 s) and a ragged batch: frame counts
     exact, normalised mel within 1e-4, two launches bitwise equal; the
     kernel and torch.stft + the mel product timed in turns (medians and
     spreads), the plain version's time, the bound; its float64 error
     within 4x the plain float32 version's
 19. the main path: a synthetic CirCor corpus (120 patients, 1-4 locations,
     6-32 s clips at 4 kHz) through cli.process (source_sr=4000: shipped at
     4 kHz, upsampled on the card) and cli.linear_eval (5 seeds, finite test
     AUROCs, mean +- std, clips/s of the process drive); the same files with
     use_pallas_mel for operaCT and operaGT (per-clip cosine to the default
     path >= 0.99999, one logmel launch a batch, none on the default path);
     the device upsample against scipy (3e-5) and the source-rate features
     against the 16 kHz host path (f32 wire, >= 0.99995); device-resident
     operaCT clips/s at B=64 with and without use_pallas_mel, in turns, and
     a profile of a use_pallas_mel batch
 20. attention modes (TPU K10 bench/gt_attn_opt.py, K11 bench/vit_attn_ablate.py):
     each of vit_attn's modes norm_before, fast, bf16_exp, no_softmax and
     q_passthrough at B=64 x 1040 x 384 (6 heads, all keys real, q
     unscaled) against its plain version (o_pre cosine and, with vit_proj,
     branch cosine >= 0.99999, two launches bitwise equal), aligned_hcat's
     ValueError; every mode name of both files chained 8 halves deep
     (bench/attn_ablate.py) with its launches by mode (vit_proj once with
     each vit_attn); each name's chain time against the stable chain, SDPA
     (scale 1.0), the plain chain and the bound
 21. fine-tuning: a synthetic CirCor corpus (REPEAT_PATIENTS) through
     cli.process, then cli.finetune compute_dtype=bfloat16 for operaCT
     (FT_SEEDS seeds, finite test AUROCs), operaGT and Audio-MAE (one seed each), FT_EPOCHS epochs, with
     the launches their steps and predict batches imply, operaCT's seed 0
     again to the same AUROC; per tower at full width and its own batch:
     the step time on the kernels against the plain bf16 path, one step's
     launches, 3 steps of both paths with the step-0 gradient rule, the
     kernel path's 3 steps bitwise equal again, after the allocator's free
     memory is filled with NaN and with noise, and under
     torch.use_deterministic_algorithms
 22. HeAR kernels vs plain: vit_qkv, vit_attn (the core, both softmax
     modes), vit_proj and vit_mlp at HeAR's ViT-L geometry (C 1024, 16
     heads of 64, hidden 4096, 112 tokens with 97 real; TPU K6 / K7): the
     attention core at B=16 and B=1 (its ms, bound, plain ms and SDPA), the
     other three at B = 1, 16 and 64 (bench/mlp_layouts.py: each timed as a
     replayed CUDA graph in turns with its library calls, addmm, addmm + the
     residual, the MLP's chain); cosine of each output or branch >= 0.99999,
     two launches bitwise equal, and the ptxas registers and spills of the
     C = 1024 kernels
 23. HeAR: a synthetic CirCor corpus (as phase 19's, REPEAT_PATIENTS) through cli.process
     pretrain=hear (2-s clips at 16 kHz, mel-PCEN and the 24 blocks on the
     card; 24 launches of each ViT kernel a batch) and cli.linear_eval
     pretrain=hear (5 seeds, finite test AUROCs, mean +- std); 20 clips'
     features against the plain bf16 flow (>= 0.99988; printed beside the
     plain flow's own spread between a batch of 16 and a clip at a time,
     ~0.99994 over 24 ViT-L blocks) and the strict f32 path, TF32 off
     (>= 0.9999, HeAR's class, and within 2x the plain flow's distance);
     device-resident clips/s at B=64, kernel and plain bf16 paths in turns
     (bench/hear_rate.py, whose --profile gives a batch's profile from a
     fresh process)
 24. CLAP: a synthetic CirCor corpus through cli.process pretrain=clap2023
     (HTS-AT at 44.1 kHz, 7-s clips, the 12 swin blocks a batch on the
     kernels: as many launches a batch as an operaCT forward) and
     pretrain=clap (Cnn14, 5-s clips, strict f32, no repo kernel), then
     cli.linear_eval pretrain=clap2023 (5 seeds, finite test AUROCs); 20
     clips' 2023 features against the plain bf16 flow (>= 0.99999) and the
     strict f32 path, TF32 off (>= 0.99995); the 2022 tower on the card
     against the CPU's float32 graph (>= 0.99999); device-resident clips/s
     at B=16, kernel and plain bf16 paths in turns (bench/clap_rate.py,
     whose --profile gives a batch's profile from a fresh process)
 25. the comparison loop from disk: a synthetic CirCor corpus through
     cli.process (operaCT, clap2023); pretrain/prepare.py writes the COLA
     and Audio-MAE manifests (counts = the valid train + val clips);
     cli.pretrain method=cola compute_dtype=bfloat16 takes an epoch from
     the port's manifest on the train kernels; cli.linear_eval (one seed)
     and cli.finetune (operaCT, 1 epoch); cli.eval_ckpts re-tests both from
     cks/ (the head's AUROC within 1e-6 of the trained one; the fine-tuned
     model's float32 re-test printed beside its bf16 AUROC);
     cli.significance model1=operaCT model2=clap2023 (5 + 5 scores, a
     finite t and p)
 26. operaCE from disk, on phase 25's corpus: the OPERA-CE checkpoint at
     the registry's path is the seed-0 init with its BatchNorms calibrated
     on 12 of the corpus's clips; cli.process with its config defaults
     (operaCE, dim 1280, that checkpoint) and at dim 512, then
     cli.linear_eval with its defaults (5 finite test AUROCs); the null
     baseline (null-efficientnet, random weights) the same way; clips/s; no
     launch of a repository kernel; the 12 clips' features on the card
     against the same float32 graph on the CPU (TF32 off), per clip >=
     0.99999 at both dims, after checking that two clips' features stand
     further apart (cosine <= 0.999)
 27. operaCE training: cli.pretrain encoder=efficientnet
     compute_dtype=bfloat16 (B=16, one epoch) from phase 25's COLA
     manifest; 3 COLA steps of the bf16 path and of the strict f32 path
     from the same weights and batches, on the card and the CPU (dropout
     off): the root mean square of the card's |bf16 - f32| / f32 loss gaps
     <= 1.25x the CPU's, the step-0 gradients by the ratio rule (the JAX package's own bf16
     flow reads ~3e-2 of the loss from its f32 step, above the ROADMAP's
     1e-3); COLA and fine-tuning step times; cli.finetune with its defaults
     (operaCE, one seed, one epoch) and cli.eval_ckpts: the head's re-test
     within 1e-6 of phase 26's seed 0, the fine-tuned model's float32
     re-test finite; no repository kernel launched
 28. the baselines: cli.process pretrain=vggish and cli.linear_eval (5
     finite AUROCs), 4 clips card vs CPU >= 0.99999; pretrain=opensmile
     (host numpy): rows equal to the host functions', the provenance
     sidecar native-emobase; one cli.finetune run (2 epochs, float32) each
     of CLAP-2022, CLAP-2023 and HeAR: finite AUROCs, step ms, no
     repository kernel launched
 29. the legacy respiratory benchmark from disk: synthetic COPD (4 kHz),
     ICBHI (4 / 10 / 44.1 kHz), SSBPR, NoseMic and MMLung (16 kHz) corpora
     (bench/resp_corpora.py, the metadata with the cells pandas types in
     its own way, read here by utils/table.py) through the ten processors'
     five here (split and label rows = the files written; the empty ICBHI
     diagnosis cell a "nan" label, MMLung's gap a NaN), extract_and_save with operaCT
     (the native C++ loader for 16-kHz WAVs, its per-file Python route for
     the rest; the route counts) and operaGT on each feature dir, launches
     exact (12 swin_attn + 12 swin_mlp an operaCT batch, 12 of each ViT
     kernel an operaGT batch); cli.linear_eval task=copd, icbhidisease,
     snoring (5 finite AUROCs each); LOOCV=True task=rr and spirometry
     (folds = subjects / recordings, finite MAE and MAPE); the NoseMic LOOCV
     on the card against the CPU, within twice the spread of CPU runs on
     features moved one ulp; cli.process clips/s on a 16-kHz CirCor corpus
     through the native loader and the Python decoder in turns
 30. respiratory continued pretraining: pretrain/prepare.py's ICBHI
     whole-recording and cycle manifests and HF_Lung's (counts = the valid
     clips); cli.pretrain method=cola icbhi + hf_lung and method=mae
     icbhicycle + hf_lung at B=16, one epoch each on the train kernels:
     launches exactly phases 8 / 16's a step and eval batch, finite losses,
     step ms
 31. data parallelism (parallel/), in fresh child processes from
     parallel/launch.py, DropPath and dropout off (each rank draws its
     own): two COLA steps of the full-width operaCT at phase 8's shape
     (B=64 x 251 frames, bf16, the train kernels) through
     data_parallel_mesh(1, backend="nccl") against the no-mesh run from the
     same weights (losses within 1e-4, step-0 leaves >= GRAD_FLOOR, the
     count under SAME_ROUNDING_BAR, the global gradient norm within 1 +-
     1e-3); the same on two gloo ranks sharing cuda:0, 32 rows a rank
     (losses within LOSS_RTOL, leaves >= GRAD_FLOOR, the count under
     GRAD_BAR, the norm within 1 +- 1e-2), an Audio-MAE CP step at phase
     16's shape (K9; the trainer's step, the global noise drawn on every
     rank; the ranks' masks together are the single-device masks), two
     ZeRO-3 COLA steps on the plain bf16 path (step-0 loss within
     LOSS_RTOL and leaves >= GRAD_FLOOR against one device; losses within
     1e-5 and leaves >= SAME_ROUNDING_BAR against plain DP on the same
     ranks, whose step 1 follows the sharded Adam update) and
     operaCT extraction of 16 10-s clips (K1-K3; per clip >= 0.99999
     against one device); launches a rank a step exactly phases 8 / 16's;
     one epoch of cli.pretrain dp=2 dist_backend=gloo (method=cola,
     encoder=htsat, bf16, B=30) on phase 8's corpus writer; step ms at world 1
     and 2 (two ranks share one card: not a scaling figure)
 32. the tensor axis (parallel/tensor.py, models/tp_blocks.py): four gloo
     ranks on cuda:0 as dp2 x tp2 in one child launch, DropPath and
     dropout off, against the same steps on one device in this process:
     (a) two megatron COLA steps of the full-width operaCT in float32 (TF32
     off) at 4 rows a data rank: step-0 loss within 1e-5, every gradient
     leaf >= 0.99999, the norm within 1 +- 1e-4, every replicated leaf bit
     for bit equal on the model peers after the steps (every leaf across
     the data axis), stage 0's qkv (3C / 2, C) on each model rank; (b) the
     megatron step on the bf16 plain route at phase 31's shape (B=64, 32
     rows a data rank) at phase 31's floors (loss within 5e-4, leaves >=
     GRAD_FLOOR, norm within 1e-2); (c) a float32 megatron Audio-MAE CP
     step (ViT-B encoder, SwinV2-CR decoder, the global noise) and (d) a
     float32 megatron operaCT fine-tuning step and a float32 COLA step with
     ZeRO-3 over the model axis, at (a)'s bars; no repository kernel
     launched on any rank; (e) cli.pretrain dp=2 tp=2 dist_backend=gloo
     (method=cola, encoder=htsat, bf16, B=16) run in every rank as torchrun
     would, 5 epochs of 24 circor clips of phase 8's writer (the resume
     checkpoint of epoch 4, full tensors) then resume=True to epoch 5 from
     it; the checkpoint loads into a one-device Cola by name. Ms a step a
     rank (host-staged gloo on one card: not a multi-card figure)
 33. analysis (analysis/, models/htsat.py, utils/profiling.py): gradient
     saliency of the full-width operaCT plus a linear head on 8 clips of
     8 s through K8 (the HTS-AT training forward on bn0's running
     statistics, DropPath off; the input gradient from swin_attn_bwd /
     swin_mlp_bwd, 10 launches each, no swin_wgrad / swin_reduce launch)
     against the plain bf16 flow (the same classes, each clip's map cosine
     >= GRAD_FLOOR, else the ratio rule against strict f32), the same
     backward with the weights taking gradients (its input gradient bit for
     bit the same, its ms beside); long-clip inference of 4 clips of 120 s
     (3751 frames, 6 crops each) with the tscam outputs through K1-K3 in
     batches of 16 crops (launches exact; latent and clipwise logits >=
     SAME_ROUNDING_BAR against the plain bf16 flow; at batches of 4 crops
     equal to the mean of the per-crop forwards within 1e-6; clips/s);
     masked-spectrogram reconstruction of operaGT (ViT-S, 256 x 64) and
     Audio-MAE (ViT-B, 1024 x 128) with the decoder, the encoder on the
     ViT forward kernels (depth launches of each), against the plain bf16
     flow (the same mask, recon cosine >= SAME_ROUNDING_BAR, loss within
     1e-3); utils.profiling.trace in a fresh child process, whose trace
     file holds swin_attn's device records
 34. megatron fine-tuning of every encoder kind (parallel/tensor.py,
     models/tp_blocks.py, train/finetune.py): four gloo ranks on cuda:0 in
     one child launch run finetune_classifier (float32, TF32 off, one
     epoch of 3 steps at 4 rows a data rank, one validation batch) under
     param_sharding=megatron: CLAP 2022 (the full Cnn14, fc1
     column-parallel), CLAP 2023 (its HTS-AT) and HeAR (the ViT-L/16) at
     dp2 x tp2, and operaGT (ViT-S, 6 heads over 4 model ranks: the head
     split) at dp1 x tp4 over the same ranks; each against the same call on
     one device in this process at phase 32's bars (step-0 loss, every
     step-0 gradient leaf, the norm), each rank's qkv / fc1 at 1/tp of its
     rows, the returned state bit for bit equal on every rank (cuDNN in its
     deterministic mode there: parallel/tensor.py::shard_model), no
     repository kernel launched on any rank; ms a step a rank (host-staged
     gloo on one card: not a multi-card figure)
The line before the last is the kernels JSON (every kernel: launches on its
main path, ms, the plain version's ms, the bound from the card's published
peaks, and one library call's ms where one computes the same function); the
last line is the result JSON. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

SEED = 0
B_KERNEL = 16  # the serving batch size
B_TRAIN = 64  # the CP batch (pairs a step)
HBM_BPS = 3.35e12  # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
F32_FLOPS = 67e12  # H100 SXM float32 FLOP/s outside the tensor cores
LOSS_RTOL = 1e-3  # 3 CP steps, kernel path vs plain bf16 path
# Step-0 gradient leaves of a CP step (the rule of ROADMAP.md's precision
# classes). Per kernel, fidelity is gated on shared inputs (phase 7: every
# leaf >= KERNEL_BAR). End to end, two bf16 forwards drift apart through 20
# blocks as far as the plain bf16 path drifts from strict f32 (PERF.md;
# heart_murmur_detection_tpu_torch/bench/grad_drift.py for the readings), so
# the step fails on a leaf under GRAD_FLOOR against the plain path, on a
# median over leaves of (1 - cos kernel-f32) / (1 - cos plain-f32) above
# F32_RATIO_MEDIAN, or on one leaf's ratio above F32_RATIO_LEAF; it prints
# the count of leaves under GRAD_BAR.
GRAD_BAR = 0.9999
GRAD_FLOOR = 0.9995
F32_RATIO_MEDIAN = 1.25
F32_RATIO_LEAF = 2.0
TPU_COSINE_R05 = 0.9999968  # BENCH_r05.json, TPU v5e, fused bf16 vs its default-precision graph
SAME_ROUNDING_BAR = 0.99999  # kernels vs the plain bf16 flow (bench/numerics_pin.py's operaCT bar)
F32_BAR = 0.99995  # the bf16 flow vs the strict float32 path, just under its readings (PERF.md)
# One kernel vs its plain version, as the cosine of the branch each adds to
# x (out - x): the residual sum hides the branch under x, so a kernel that
# dropped or transposed the rel-pos bias would still give a residual cosine
# near 0.99997, but a branch cosine near 0.9998.
KERNEL_BAR = 0.99999


def _cos(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _require(cond: bool, what: str):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def _time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class Work:
    """Bytes and operations of a kernel's launches, summed: each input read
    once and each output written once; bound = the larger of bytes over the
    HBM rate and operations over the peak of their type (dense bf16 unless
    given), per launch."""

    def __init__(self, peak_flops: float = BF16_FLOPS):
        self.t_bytes = self.t_ops = self.bound_s = 0.0
        self.peak = peak_flops

    def add(self, nbytes: float, ops: float, n: int = 1):
        tb, to = nbytes / HBM_BPS, ops / self.peak
        self.t_bytes += n * tb
        self.t_ops += n * to
        self.bound_s += n * max(tb, to)

    @property
    def bound_ms(self) -> float:
        return self.bound_s * 1e3

    @property
    def bound_by(self) -> str:
        return "operations" if self.t_ops >= self.t_bytes else "bytes"


def _attn_work(B, H, W, C, heads, shift):
    n, Cp = B * H * W, heads * 32
    nbytes = 4 * n * C + 2 * (3 * Cp * C + C * C) + 4 * (3 * Cp + 3 * C + heads * 4096)
    nbytes += 4 * (H * W // 64) * 4096 if shift else 0
    return nbytes, n * (8 * C * C + 256 * C)


def _mlp_work(B, H, W, C):
    n = B * H * W
    return 4 * n * C + 16 * C * C + 4 * 7 * C, 16 * n * C * C


def _bwd_work(n, C, heads, mask):
    """The backward kernels' shares of K8's backward function, one block of
    n tokens: ((bytes, operations) of swin_mlp_bwd, of swin_attn_bwd).
    MLP half: h1, dy and the weights in, dh1 out; the fc1 recompute and the
    two data products (24 n C^2). Attention half: x, dh1, the weights, the
    gathered bias and the mask in, dx out; the qkv recompute and the proj and
    qkv data products (14 n C^2, head dims unpadded) and the six window
    products (768 n C). The weight products and the gradients written once
    are swin_wgrad's and swin_reduce's shares; the operand rows and float32
    partials that design (b) moves between the kernels are in no bound."""
    hid = 4 * C
    mlp = 6 * n * C + 2 * 2 * hid * C + 4 * (3 * C + hid), 6 * n * C * hid
    attn = 6 * n * C + 2 * 4 * C * C + 4 * (6 * C + heads * 4096)
    attn += 4 * mask.numel() if mask is not None else 0
    return mlp, (attn, n * (14 * C * C + 768 * C))


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)
    return smi


def phase_build():
    from heart_murmur_detection_tpu_torch.ops import _build

    res = _build.build()
    _build.load_library()
    usage = [ln.strip() for ln in res.log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"[build] nvcc {res.seconds:.1f} s -> {os.path.relpath(res.path)}; "
          f"ptxas: {' | '.join(usage)}", flush=True)
    return res.log


def phase_kernels(model, dev):
    """Each eval kernel vs its plain version at the main path's stage
    geometries: the branch cosine, a second launch bitwise equal to the
    first, the kernel's ms against its bound and the plain version's, and
    for swin_mlp the library chain's. Returns {name: measurement}: times
    and bounds summed over one forward's 12 launches of each kernel at
    B=16."""
    import torch

    from heart_murmur_detection_tpu_torch.bench.swin_fwd_time import mlp_chain
    from heart_murmur_detection_tpu_torch.ops import swin

    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    stages = model.htsat.prepared(torch.bfloat16)
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "err": 0.0, "work": Work(), "library_ms": None}
           for k in ("swin_attn", "swin_mlp")}
    for i, st in enumerate(stages):
        C, H = st.blocks[0].dim, 64 >> i
        heads = st.blocks[0].heads
        x = (torch.randn(B_KERNEL, H, H, C, generator=g) * 0.5).to(dev, torch.bfloat16)
        shifts = (0, st.shift) if st.shift else (0,)
        for s in shifts:
            p = st.blocks[1 if s else 0]
            m = st.mask if s else None
            n_launch = len(st.blocks) // len(shifts)  # launches at this shift per forward
            cases = [("swin_attn", lambda: swin.swin_attn(x, p, m, s),
                      lambda: swin.swin_attn_ref(x, p, m, s))]
            tot["swin_attn"]["work"].add(*_attn_work(B_KERNEL, H, H, C, heads, s), n=n_launch)
            if s == 0:
                cases.append(("swin_mlp", lambda: swin.swin_mlp(x, p), lambda: swin.swin_mlp_ref(x, p)))
                n_mlp = len(st.blocks)
                tot["swin_mlp"]["work"].add(*_mlp_work(B_KERNEL, H, H, C), n=n_mlp)
            xf = x.float()
            for name, kern, plain in cases:
                got, want, again = kern(), plain(), kern()
                torch.cuda.synchronize()
                cos = _cos((got.float() - xf).cpu(), (want.float() - xf).cpu())
                same = torch.equal(got, again)
                err = float((got.float() - want.float()).abs().max())
                k_ms, p_ms = _time_ms(kern), _time_ms(plain, iters=5, warm=1)
                n = n_launch if name == "swin_attn" else n_mlp
                tot[name]["ms"] += n * k_ms
                tot[name]["plain_ms"] += n * p_ms
                tot[name]["err"] = max(tot[name]["err"], err)
                one = Work()
                one.add(*(_attn_work(B_KERNEL, H, H, C, heads, s) if name == "swin_attn"
                          else _mlp_work(B_KERNEL, H, H, C)))
                chain = ""
                if name == "swin_mlp":
                    c_ms = _time_ms(mlp_chain(x, p, 1e-5))
                    chain = f"; library chain (layer_norm, addmm, gelu, addmm, add) {c_ms:.4f} ms"
                print(f"[kernel] {name} C={C} H=W={H} shift={s} B={B_KERNEL}: branch cos {cos:.7f} "
                      f"max|d| {err:.4g}; second launch bitwise equal {same}; kernel {k_ms:.4f} ms "
                      f"bound {one.bound_ms:.4f} ms ({one.bound_by}, {one.bound_ms / k_ms:.1%} of "
                      f"it) plain {p_ms:.4f} ms{chain}; {n} a forward", flush=True)
                _require(cos >= KERNEL_BAR and same,
                         f"{name} C={C} shift={s} branch cosine {cos} < {KERNEL_BAR} or not "
                         f"repeatable ({same})")
    return tot


def _branch(got, want, base):
    return _cos((got.float() - base.float()).cpu(), (want.float() - base.float()).cpu())


def phase_train_kernels(model, dev):
    """The train kernels vs their plain versions at the stage 0-2 geometries
    and the CP batch. Returns {name: measurement}: times and bounds summed
    over one CP step's launches (2 views x depth blocks a stage)."""
    import torch

    from heart_murmur_detection_tpu_torch.bench.swin_bwd_time import attn_bwd_chain, mlp_bwd_chain
    from heart_murmur_detection_tpu_torch.ops import swin
    from heart_murmur_detection_tpu_torch.ops import swin_train as st

    B = B_TRAIN
    g = torch.Generator(device="cpu").manual_seed(SEED + 3)
    chains = {"swin_mlp_bwd": 0.0, "swin_attn_bwd": 0.0}  # the library chains over a CP step
    cfg = model.htsat.config
    stages = model.htsat.prepared(torch.bfloat16)
    names = ("swin_attn_bwd", "swin_mlp_bwd", "swin_wgrad", "swin_reduce")
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "err": 0.0, "work": Work(),
               "library_ms": 0.0 if k in ("swin_wgrad", "swin_reduce") else None} for k in names}
    k = torch.tensor([0.0, 1 / 0.9, 1.0, 1 / 0.9] * (B // 4), device=dev)
    design = [0.0, 0.0]  # a step's design traffic (bytes), K8 backward bound (s)
    for i in range(3):
        sg = stages[i]
        p0 = sg.blocks[0]
        C, H, heads = p0.dim, 64 >> i, p0.heads
        n, hidden = B * H * H, 4 * C
        x = (torch.randn(B, H, H, C, generator=g) * 0.5).to(dev, torch.bfloat16)
        dy = (torch.randn(B, H, H, C, generator=g) * 0.1).to(dev, torch.bfloat16)
        blocks = cfg.depths[i]  # blocks a step at each shift: 2 views x depth / 2
        for s in (0, sg.shift):
            p = sg.blocks[1 if s else 0]
            m = sg.mask if s else None
            tag = f"C={C} H=W={H} shift={s} B={B}"
            # forward halves with the multipliers
            h1 = swin.swin_attn_ref(x, p, m, s, kmul=k)
            fa = swin.swin_attn(x, p, m, s, kmul=k)
            fm, ym = swin.swin_mlp(h1, p, k), swin.swin_mlp_ref(h1, p, k)
            torch.cuda.synchronize()
            ca, cm = _branch(fa, h1, x), _branch(fm, ym, h1)
            fa_ms = _time_ms(lambda: swin.swin_attn(x, p, m, s, kmul=k), iters=10, warm=2)
            fm_ms = _time_ms(lambda: swin.swin_mlp(h1, p, k), iters=10, warm=2)
            print(f"[train fwd] {tag}: swin_attn k branch cos {ca:.7f} {fa_ms:.4f} ms; "
                  f"swin_mlp k branch cos {cm:.7f} {fm_ms:.4f} ms", flush=True)
            _require(min(ca, cm) >= KERNEL_BAR, f"train forward {tag} cosines {ca} {cm}")
            # backward halves: kernels twice (bitwise), plain once
            runs_m = [st.swin_mlp_bwd(h1, dy, k, p) for _ in range(2)]
            dh1, gm = st.swin_mlp_bwd_ref(h1, dy, k, p)
            runs_a = [st.swin_attn_bwd(x, dh1, k, p, m, s) for _ in range(2)]
            dx, ga = st.swin_attn_bwd_ref(x, dh1, k, p, m, s)
            torch.cuda.synchronize()
            for what, runs, want_d, base, want_g in (
                ("swin_mlp_bwd", runs_m, dh1, dy, gm), ("swin_attn_bwd", runs_a, dx, dh1, ga)
            ):
                (d1, g1), (d2, g2) = runs
                same = torch.equal(d1, d2) and all(torch.equal(g1[q], g2[q]) for q in g1)
                _require(same, f"{what} {tag}: two launches differ")
                cos = {"d_in": _branch(d1, want_d, base)}
                cos.update({q: _cos(g1[q].cpu(), want_g[q].cpu()) for q in want_g})
                err = float((d1.float() - want_d.float()).abs().max())
                tot[what]["err"] = max(tot[what]["err"], err)
                lo = min(cos, key=cos.get)
                print(f"[train bwd] {what} {tag}: bitwise repeatable; max|d| {err:.4g}; cosines "
                      + " ".join(f"{q} {v:.7f}" for q, v in cos.items()), flush=True)
                _require(cos[lo] >= KERNEL_BAR, f"{what} {tag}: {lo} cosine {cos[lo]} < {KERNEL_BAR}")
            # times a launch: each backward kernel alone, the plain half whole
            mb_ms = _time_ms(lambda: st.swin_mlp_bwd_launch(h1, dy, k, p), iters=10, warm=2)
            ab_ms = _time_ms(lambda: st.swin_attn_bwd_launch(x, dh1, k, p, m, s), iters=10, warm=2)
            mp_ms = _time_ms(lambda: st.swin_mlp_bwd_ref(h1, dy, k, p), iters=3, warm=1)
            ap_ms = _time_ms(lambda: st.swin_attn_bwd_ref(x, dh1, k, p, m, s), iters=3, warm=1)
            tot["swin_mlp_bwd"]["ms"] += blocks * mb_ms
            tot["swin_attn_bwd"]["ms"] += blocks * ab_ms
            tot["swin_mlp_bwd"]["plain_ms"] += blocks * mp_ms
            tot["swin_attn_bwd"]["plain_ms"] += blocks * ap_ms
            # the yardsticks: each half's backward as library calls in bf16
            # (autograd), and each call's grid launches by the profiler
            mc_ms = _time_ms(mlp_bwd_chain(h1, dy, k, p, 1e-5), iters=10, warm=2)
            ac_ms = _time_ms(attn_bwd_chain(x, dh1, k, p, m, s), iters=10, warm=2)
            chains["swin_mlp_bwd"] += blocks * mc_ms
            chains["swin_attn_bwd"] += blocks * ac_ms
            split_m = _device_ms(lambda: st.swin_mlp_bwd_launch(h1, dy, k, p), groups_by=MLP_BWD_LAUNCHES)
            split_a = _device_ms(lambda: st.swin_attn_bwd_launch(x, dh1, k, p, m, s),
                                 groups_by=SWIN_ATTN_BWD_LAUNCHES)
            print(f"[train kernels] {tag}: the halves as library chains (autograd backward in "
                  f"bf16): MLP {mc_ms:.4f} ms, attention {ac_ms:.4f} ms; the grid launches of a "
                  f"call by the profiler (ms): swin_mlp_bwd "
                  f"{ {q: round(v, 4) for q, v in split_m.items()} }, swin_attn_bwd "
                  f"{ {q: round(v, 4) for q, v in split_a.items()} }", flush=True)
            _, (m_g, g_g, dyk_g, da1_g), part_m = st.swin_mlp_bwd_launch(h1, dy, k, p)
            _, (h_g, dw_g, opre_g, dqkv_g), part_a = st.swin_attn_bwd_launch(x, dh1, k, p, m, s)
            # bounds: each kernel's share of the K8 backward function (see
            # _bwd_work); the operand rows and partials are design traffic
            (wm, om), (wa, oa) = _bwd_work(n, C, heads, m)
            tot["swin_mlp_bwd"]["work"].add(wm, om, n=blocks)
            tot["swin_attn_bwd"]["work"].add(wa, oa, n=blocks)
            bm, ba = Work(), Work()
            bm.add(wm, om)
            ba.add(wa, oa)
            extra = 2 * sum(t.numel() for t in (m_g, g_g, dyk_g, da1_g, h_g, dw_g, opre_g, dqkv_g))
            extra += 2 * 4 * (part_m.numel() + part_a.numel())  # written, read by swin_reduce
            # the step's weight products at these shapes, one launch each; M:
            # the product's rows without the padded head columns
            ops_w, gbytes = 0.0, 4 * (part_m.shape[1] + part_a.shape[1])
            for a_, b_, M in ((da1_g, m_g, hidden), (dyk_g, g_g, C), (dqkv_g, h_g, 3 * C),
                              (dw_g, opre_g, C)):
                Mp, N = a_.shape[1], b_.shape[1]
                got, want = st.swin_wgrad(a_, b_), st.wgrad_ref(a_, b_)
                torch.cuda.synchronize()
                c = _cos(got.cpu(), want.cpu())
                _require(c >= KERNEL_BAR, f"swin_wgrad {tag} {tuple(a_.shape)} cosine {c}")
                _require(torch.equal(got, st.swin_wgrad(a_, b_)), f"swin_wgrad {tag} not repeatable")
                S, chunk = st.wgrad_split(n, Mp, N)
                extra += 2 * n * (Mp + N)  # the operand rows read back
                if S > 1:  # the chunks' partial tiles, written and summed inside
                    rows = st.wgrad_tile_rows(Mp)
                    extra += 2 * 4 * S * -(-Mp // rows) * rows * -(-N // st.WGRAD_TILE) * st.WGRAD_TILE
                w_ms = _time_ms(lambda: st.swin_wgrad(a_, b_), iters=10, warm=2)
                l_ms = _time_ms(lambda: torch.mm(a_.t(), b_), iters=10, warm=2)
                tot["swin_wgrad"]["ms"] += blocks * w_ms
                tot["swin_wgrad"]["plain_ms"] += blocks * _time_ms(lambda: st.wgrad_ref(a_, b_), iters=3, warm=1)
                tot["swin_wgrad"]["library_ms"] += blocks * l_ms
                # its share of the function: the product's operations and its
                # float32 gradient written once (the operands never leave the
                # chip in the fused function)
                tot["swin_wgrad"]["work"].add(4 * M * N, 2 * n * M * N, n=blocks)
                ops_w += 2 * n * M * N
                gbytes += 4 * M * N
                tot["swin_wgrad"]["err"] = max(tot["swin_wgrad"]["err"], float((got - want).abs().max()))
                bw = Work()
                bw.add(4 * M * N, 2 * n * M * N)
                print(f"[train wgrad] {tag}: ({n}, {Mp}) x ({n}, {N}) in {S} chunks of {chunk} "
                      f"(groups of {st.wgrad_group(S)}), one launch: cos {c:.7f}, bitwise "
                      f"repeatable; {w_ms:.4f} ms, torch.mm {l_ms:.4f} ms ({w_ms / l_ms:.2f}x), "
                      f"bound {bw.bound_ms:.4f} ({bw.bound_by})", flush=True)
            for part in (part_m, part_a):
                S, L = part.shape
                got, want = st.swin_reduce(part), st.reduce_ref(part)
                _require(torch.equal(got, want), f"swin_reduce {tag} ({S}, {L}) differs from in-order sum")
                # its share: the column-sum gradients (biases, LN, rel-pos
                # bias) written once
                _reduce_row(tot["swin_reduce"], part, blocks, tag)
            design[0] += blocks * extra
            fn = Work()
            fn.add(wm + wa + gbytes, om + oa + ops_w)
            design[1] += blocks * fn.bound_s
            print(f"[train kernels] {tag}: a launch: swin_mlp_bwd {mb_ms:.4f} ms (bound "
                  f"{bm.bound_ms:.4f}, {bm.bound_by}; plain half {mp_ms:.4f}), swin_attn_bwd "
                  f"{ab_ms:.4f} ms (bound {ba.bound_ms:.4f}, {ba.bound_by}; plain half "
                  f"{ap_ms:.4f}); {blocks} of each a step; both column-sum reductions equal "
                  f"to the in-order sum; K8 backward of one block bound {fn.bound_ms:.4f} ms "
                  f"({fn.bound_by}); design operand and partial traffic {extra / 1e6:.1f} MB "
                  f"= {extra / HBM_BPS * 1e3:.4f} ms at the HBM rate", flush=True)
    print(f"[train kernels] a CP step: the K8 backward function (20 blocks) bound "
          f"{design[1] * 1e3:.4f} ms; design (b)'s operand and partial traffic {design[0] / 1e9:.3f} "
          f"GB = {design[0] / HBM_BPS * 1e3:.4f} ms at the HBM rate, in no bound; the backward "
          f"halves {tot['swin_mlp_bwd']['ms']:.4f} / {tot['swin_attn_bwd']['ms']:.4f} ms against "
          f"their library chains {chains['swin_mlp_bwd']:.4f} / {chains['swin_attn_bwd']:.4f} ms",
          flush=True)
    return tot


def _reduce_row(tot: dict, part, launches: int, tag: str):
    """Times swin_reduce on one partial block (S, L) against its plain
    version and part.sum(0) (kernel and sum(0) in turns), adds them to `tot`
    `launches` times with the bound (the L sums written once), and prints
    the shape's line."""
    from heart_murmur_detection_tpu_torch.ops import swin_train as st

    S, L = part.shape
    k_ms, l_ms = [], []
    for _ in range(3):  # in turns; the least of each side (a call is host-bound below ~10 us)
        k_ms.append(_time_ms(lambda: st.swin_reduce(part), iters=20, warm=3))
        l_ms.append(_time_ms(lambda: part.sum(0), iters=20, warm=3))
    k, lib = min(k_ms), min(l_ms)
    tot["ms"] += launches * k
    tot["plain_ms"] += launches * _time_ms(lambda: st.reduce_ref(part), iters=3, warm=1)
    tot["library_ms"] += launches * lib
    tot["work"].add(4 * L, 0, n=launches)
    print(f"[swin_reduce] {tag}: ({S}, {L}) x{launches} a step, equal to the in-order sum; "
          f"{k:.4f} ms, sum(0) {lib:.4f} ms ({k / lib:.2f}x), {4 * S * L / k / 1e6:.0f} GB/s "
          f"read", flush=True)


def _wavs(d: str):
    import numpy as np

    from heart_murmur_detection_tpu_torch.utils.audio_io import write_wav

    r = np.random.default_rng(SEED)
    paths = []
    for i in range(20):
        sec = 6.0 + 26.0 * i / 19
        t = np.arange(int(sec * 16000)) / 16000
        x = 0.3 * np.sin(2 * np.pi * (60 + 7 * i) * t) + 0.05 * r.standard_normal(len(t))
        p = os.path.join(d, f"clip{i:02d}.wav")
        write_wav(p, x.astype(np.float32), 16000)
        paths.append(p)
    return paths


def _http(url, data=None, ctype=None):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype} if ctype else {})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def phase_serving(d, device="cuda"):
    import numpy as np

    from heart_murmur_detection_tpu_torch.cli.serve import make_server
    from heart_murmur_detection_tpu_torch.ops import swin

    paths = _wavs(d)
    swin.reset_launch_counts()  # just before the main path
    t0 = time.time()
    srv = make_server(
        {"pretrain": "operaCT", "dim": 768, "batch_size": B_KERNEL, "random_init": True,
         "device": device},
        port=0,
    )
    warm_s = time.time() - t0
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        code, body = _http(url + "/healthz")
        _require(code == 200 and body["status"] == "ok", f"/healthz {code} {body}")
        t1 = time.time()
        code, body = _http(url + "/extract", json.dumps({"paths": paths}).encode(), "application/json")
        served_s = time.time() - t1
        _require(code == 200, f"/extract paths -> {code}")
        feats = np.asarray(body["features"], np.float32)
        _require(feats.shape == (20, 768), f"served shape {feats.shape}")
        _require(bool(np.isfinite(feats).all()), "non-finite served features")
        with open(paths[3], "rb") as f:
            code, one = _http(url + "/extract", f.read(), "audio/wav")
        _require(code == 200, f"/extract wav bytes -> {code}")
        one = np.asarray(one["features"], np.float32)
        _require(one.shape == (1, 768), f"wav-bytes shape {one.shape}")
        ex = srv.extractor
        offline = ex.extract_files(paths)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    counts = swin.launch_counts()
    batches = ex.n_dispatched
    _require(np.allclose(feats, offline, atol=1e-5), "served != offline extract_files")
    one_cos = _cos(one[0], offline[3])
    _require(one_cos >= SAME_ROUNDING_BAR, f"wav-bytes vs offline cosine {one_cos}")
    _require(
        counts["swin_attn"] == counts["swin_mlp"] == 12 * batches,
        f"launch counts {counts} for {batches} batches (want 12 + 12 per batch)",
    )
    print(f"[serve] 200s; features (20, 768) finite; served == offline; wav-bytes cos {one_cos:.7f}; "
          f"launches {counts} over {batches} batches (12 + 12 each); warm {warm_s:.1f} s; "
          f"20-clip request {served_s:.2f} s", flush=True)
    return ex, paths, offline, counts


def _reference_fn(ex, mm_dtype):
    """The extractor's batch forward with the encoder on its plain versions."""
    import torch

    from heart_murmur_detection_tpu_torch.models.htsat_fused import htsat_apply_fused

    def fn(wav, lengths):
        with torch.inference_mode():
            mel, nf = ex._mel(*ex._prologue(wav, lengths))
            return htsat_apply_fused(ex.model.htsat, mel, nf, mm_dtype, impl="plain")

    return fn


def phase_numerics(ex, paths, served):
    import torch

    def run(mm_dtype):
        old = ex._fn
        ex._fn = _reference_fn(ex, mm_dtype)
        try:
            return ex.extract_files(paths)
        finally:
            ex._fn = old

    c_same = _cos(served, run(torch.bfloat16))
    c_f32 = _cos(served, run(torch.float32))
    print(f"[numerics] cosine vs plain bf16 flow {c_same:.7f} (bar {SAME_ROUNDING_BAR}); "
          f"vs strict f32 plain, TF32 off {c_f32:.7f} (bar {F32_BAR}; the TPU v5e recorded "
          f"{TPU_COSINE_R05} against its default-precision graph)", flush=True)
    _require(c_same >= SAME_ROUNDING_BAR, f"served vs plain bf16 flow cosine {c_same}")
    _require(c_f32 >= F32_BAR, f"served vs strict float32 path cosine {c_f32}")

    # operaCT dim 512 takes the reference's float32 graph (the JAX extractor
    # fuses only 768): no swin kernel, and the card agrees with the CPU
    import numpy as np

    from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor
    from heart_murmur_detection_tpu_torch.ops import swin

    sub = paths[:8]
    kw = dict(dim=512, batch_size=B_KERNEL, random_init=True, seed=SEED,
              compute_dtype=torch.bfloat16)
    card = FeatureExtractor("operaCT", device="cuda", **kw)
    swin.reset_launch_counts()  # just before the 512-d path
    f512 = card.extract_files(sub)
    counts = swin.launch_counts()
    cpu = FeatureExtractor("operaCT", device="cpu", **kw).extract_files(sub)
    c512 = float(_per_clip_cos(f512, cpu).min())
    print(f"[numerics] operaCT dim=512 (compute_dtype bf16 asked): the float32 graph on the card "
          f"vs the same graph on the CPU, per-clip cosine min {c512:.8f} over {len(sub)} clips "
          f"(bar {SAME_ROUNDING_BAR}), max|d| {float(np.abs(f512 - cpu).max()):.3g}; swin "
          f"launches {counts['swin_attn']} + {counts['swin_mlp']} (want 0)", flush=True)
    _require(counts["swin_attn"] == counts["swin_mlp"] == 0, f"dim 512 launched {counts}")
    _require(f512.shape == (len(sub), 512) and c512 >= SAME_ROUNDING_BAR,
             f"dim 512 card vs CPU cosine {c512}")


def phase_throughput(ex, smi):
    import torch

    dev = ex.device
    B, n = 64, 10 * 16000
    npad = (n + 511) // 512 * 512
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    wav = torch.zeros(B, npad, dtype=torch.int16)
    wav[:, :n] = (torch.randn(B, n, generator=g) * 3000).to(torch.int16)
    wav = wav.to(dev)
    lengths = torch.full((B,), n, dtype=torch.int32, device=dev)
    kern, plain = ex._build(), _reference_fn(ex, torch.bfloat16)
    k_ms = _time_ms(lambda: kern(wav, lengths), iters=10, warm=2)
    p_ms = _time_ms(lambda: plain(wav, lengths), iters=3, warm=1)
    print(f"[throughput] {smi}: device-resident 10-s clips B={B}: kernel path {k_ms:.2f} ms/batch "
          f"= {B * 1000 / k_ms:.1f} clips/s; plain bf16 path {p_ms:.2f} ms/batch "
          f"= {B * 1000 / p_ms:.1f} clips/s", flush=True)


CP_CORPORA = ("circor", "physionet16", "pascal_A")


def _write_corpora(root: str):
    """Synthetic spectrogram corpora in the heart manifests' layout:
    feature/<corpus>_eval/entire_spec_filenames.npy lists the clips (names
    without .npy), 300 clips of 260-1000 frames x 64 mels each."""
    import numpy as np

    r = np.random.default_rng(SEED + 4)
    for name in CP_CORPORA:
        d = os.path.join(root, "feature", f"{name}_eval")
        os.makedirs(os.path.join(d, "spec"))
        names = []
        for i, t in enumerate(r.integers(260, 1001, 300)):
            f = os.path.join("feature", f"{name}_eval", "spec", f"{i:03d}")
            np.save(os.path.join(root, f + ".npy"),
                    (r.standard_normal((int(t), 64)) * 10 - 40).astype(np.float32))
            names.append(f)
        np.save(os.path.join(d, "entire_spec_filenames.npy"), np.asarray(names))


def _reduce_per_step(cfg) -> int:
    """swin_reduce launches of one CP step: in each train block of stages
    0-2 and each of the two views, one for each backward kernel's column
    sums (swin_wgrad sums its own chunks)."""
    return 2 * 2 * sum(cfg.depths[:3])


def _cp_cli(root: str, fused_train: bool):
    """One epoch of CP at B=64 through cli.pretrain in `root`; returns
    (history entry, launch counts of the run)."""
    from heart_murmur_detection_tpu_torch.cli import pretrain
    from heart_murmur_detection_tpu_torch.ops import swin

    argv = ["encoder=htsat", "method=cola", "compute_dtype=bfloat16", "batch_size=64",
            "epoches=1", "seed=0", "title=smoke", "device=cuda",
            f"fused_train={fused_train}", *(f"{c}=True" for c in CP_CORPORA)]
    cwd = os.getcwd()
    os.chdir(root)
    try:
        swin.reset_launch_counts()  # just before the main path
        ((_, history, _),) = pretrain.main(argv)
        counts = swin.launch_counts()
    finally:
        os.chdir(cwd)
    return history[0], counts


def phase_cp(smi: str, dev):
    """CP through the CLI on the train kernels and on the plain bf16 path;
    3-step agreement of the two; steady-state step times; a profile."""
    import copy
    import math

    import torch

    from heart_murmur_detection_tpu_torch.extract.registry import initialize_pretrained_model
    from heart_murmur_detection_tpu_torch.models import bn as bn_mod
    from heart_murmur_detection_tpu_torch.models.htsat_train_fused import _block_params
    from heart_murmur_detection_tpu_torch.ops.swin_train import fused_swin_block_train
    from heart_murmur_detection_tpu_torch.pretrain import cola_training as ct
    from heart_murmur_detection_tpu_torch.pretrain import steps
    from heart_murmur_detection_tpu_torch.pretrain.data import (
        OPTIMAL_MAX_LEN_COLA, MultiCorpusSampler, load_corpus)

    base = initialize_pretrained_model("operaCT", random_init=True, seed=SEED).to(dev).train()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        _write_corpora(root)
        print(f"[cp] 3 corpora x 300 clips written in {time.time() - t0:.1f} s", flush=True)
        h, counts = _cp_cli(root, True)
        n_val = 3  # one validation batch of 30 clips a corpus
        per_step = {"swin_attn_bwd": 20, "swin_mlp_bwd": 20, "swin_wgrad": 80,
                    "swin_reduce": _reduce_per_step(base.htsat.config)}
        ok = all(counts[q] == v * h["steps"] for q, v in per_step.items())
        ok &= counts["swin_attn"] == counts["swin_mlp"] == 20 * h["steps"] + 24 * n_val
        _require(ok, f"launch counts {counts} for {h['steps']} steps and {n_val} eval batches "
                     f"(want {per_step} a step)")
        _require(all(math.isfinite(h[q]) for q in ("train_loss", "valid_loss")), f"losses {h}")
        print(f"[cp] cli.pretrain, train kernels, {smi}: {h['steps']} steps, {h['pairs']} pairs in "
              f"{h['train_seconds']:.2f} s (first step included) = {h['steps'] / h['train_seconds']:.3f} "
              f"steps/s, {h['pairs'] / h['train_seconds']:.1f} pairs/s; train loss "
              f"{h['train_loss']:.4f} valid {h['valid_loss']:.4f}; launches {counts} "
              f"(20 of each backward kernel a step, 80 swin_wgrad)", flush=True)
        hp, _ = _cp_cli(root, False)
        _require(all(math.isfinite(hp[q]) for q in ("train_loss", "valid_loss")), f"losses {hp}")
        print(f"[cp] cli.pretrain, plain bf16 path: {hp['steps']} steps, {hp['pairs']} pairs in "
              f"{hp['train_seconds']:.2f} s = {hp['steps'] / hp['train_seconds']:.3f} steps/s, "
              f"{hp['pairs'] / hp['train_seconds']:.1f} pairs/s; train loss {hp['train_loss']:.4f} "
              f"valid {hp['valid_loss']:.4f}", flush=True)
        cwd = os.getcwd()
        os.chdir(root)
        try:
            corpora = [load_corpus(c, OPTIMAL_MAX_LEN_COLA[c]) for c in CP_CORPORA]
        finally:
            os.chdir(cwd)
    sampler = MultiCorpusSampler(corpora, B_TRAIN, seed=SEED + 5)
    batches = [tuple(torch.from_numpy(v).to(dev) for v in sampler.next_batch()[1]) for _ in range(3)]

    def run(impl, mm_dtype=torch.bfloat16, n_steps=3, weights=None):
        """Losses and gradients of n_steps steps; with `weights`, each step
        starts from weights[i] (the plain path's state before its step i)."""
        model = copy.deepcopy(base)
        opt = steps.adam_with_epoch_decay(list(model.parameters()), 5)
        gen = torch.Generator(device=dev).manual_seed(SEED + 6)
        losses, grads, states = [], [], []
        for i, (x1, x2) in enumerate(batches[:n_steps]):
            if weights is not None:
                model.load_state_dict(weights[i])
            states.append(copy.deepcopy(model.state_dict()))
            opt.zero_grad()
            loss, _, stats = ct.forward_backward(model, x1, x2, gen, mm_dtype, impl, 0.1)
            grads.append({q: w.grad.detach().clone() for q, w in model.named_parameters()})
            opt.step()
            bn_mod.commit(stats)
            losses.append(float(loss.detach()))
        return losses, grads, states

    # The kernel path takes each step from the plain path's weights: at a
    # COLA step from random weights, Adam's first update (lr * sign(g)) turns
    # gradient elements at rounding-noise level into whole-lr moves, so two
    # bf16 paths left to train apart diverge by more than LOSS_RTOL after a
    # step even when their forwards differ by a ulp (PERF.md §6)
    lp, gp, wp = run("plain")
    lk, gk, _ = run("kernel", weights=wp)
    lf, gf, _ = run("autograd", torch.float32, 1)  # strict f32, step 0
    _step0_rule("[cp] 3 steps, the kernel path's each from the plain path's weights, same "
                "batches and generator", lk, lp, lf, gk[0], gp[0], gf[0])
    for i in (1, 2):  # every step's gradients, leaf by leaf, as step 0's
        cos = {q: _cos(gk[i][q].cpu(), gp[i][q].cpu()) for q in gp[i] if float(gp[i][q].norm()) > 0}
        lo = min(cos, key=cos.get)
        print(f"[cp] step {i} from the plain path's weights: gradient cosines, kernel vs plain "
              f"bf16 path over {len(cos)} leaves: min {cos[lo]:.7f} ({lo}) (bar {GRAD_FLOOR})",
              flush=True)
        _require(cos[lo] >= GRAD_FLOOR, f"step {i} gradient {lo} cosine {cos[lo]} < {GRAD_FLOOR}")

    # steady-state step times at the full crop (circor, 251 frames)
    circor = MultiCorpusSampler(corpora[:1], B_TRAIN, seed=SEED + 7).next_batch()[1]
    x1, x2 = (torch.from_numpy(v).to(dev) for v in circor)
    for impl in ("kernel", "plain"):
        model = copy.deepcopy(base)
        opt = steps.adam_with_epoch_decay(list(model.parameters()), 5)
        gen = torch.Generator(device=dev).manual_seed(SEED + 7)
        step = lambda: ct.train_step(model, opt, x1, x2, gen, torch.bfloat16, impl, 0.1)
        ms = _time_ms(step, iters=5, warm=1)
        print(f"[cp] steady state, {impl} path, B={B_TRAIN} x {x1.shape[1]} frames: {ms:.2f} ms/step "
              f"= {1000 / ms:.3f} steps/s, {B_TRAIN * 1000 / ms:.1f} pairs/s", flush=True)
        del model, opt
    _cp_profile(base, x1, x2, dev, _block_params, fused_swin_block_train, ct, steps)
    return counts


def _step0_rule(tag, lk, lp, lf, gk, gp, gf, skip=()):
    """The 3-step loss agreement and the step-0 gradient rule of ROADMAP's
    precision classes: losses of the kernel path (lk) and the plain bf16
    path (lp) within LOSS_RTOL; each leaf kernel vs plain >= GRAD_FLOOR; the
    median over leaves of (1 - cos kernel-f32) / (1 - cos plain-f32) <=
    F32_RATIO_MEDIAN and each leaf's <= F32_RATIO_LEAF. Leaves named in
    `skip` (exact gradient 0, float noise in every path) are left out."""
    rel = [abs(a - b) / abs(b) for a, b in zip(lk, lp)]
    leaf_cos = lambda a, b: {q: _cos(a[q].cpu(), b[q].cpu()) if float(b[q].norm()) > 0 else 1.0
                             for q in b if not q.endswith(skip)}
    cos, cos_kf, cos_pf = leaf_cos(gk, gp), leaf_cos(gk, gf), leaf_cos(gp, gf)
    lo = min(cos, key=cos.get)
    ratio = {q: (1 - cos_kf[q]) / max(1 - cos_pf[q], 1e-7) for q in cos}
    far = [q for q in cos if 1 - cos_kf[q] > F32_RATIO_LEAF * (1 - cos_pf[q]) + 1e-5]
    med = lambda d: sorted(d.values())[len(d) // 2]
    print(f"{tag}: losses kernel {[round(v, 6) for v in lk]} plain {[round(v, 6) for v in lp]}, "
          f"max rel diff {max(rel):.3g} (bar {LOSS_RTOL}); step-0 gradient cosines, kernel vs "
          f"plain bf16 path over {len(cos)} leaves: min {cos[lo]:.7f} ({lo}), median "
          f"{med(cos):.7f}, {sum(v < GRAD_BAR for v in cos.values())} leaves under {GRAD_BAR} "
          f"(bar {GRAD_FLOOR}); against strict f32 (step-0 loss {lf[0]:.6f}): kernel path min "
          f"{min(cos_kf.values()):.7f} median {med(cos_kf):.7f}, plain bf16 path min "
          f"{min(cos_pf.values()):.7f} median {med(cos_pf):.7f}; (1 - cos) kernel/plain vs f32 "
          f"median {med(ratio):.3f} max {max(ratio.values()):.3f} (bars: median "
          f"{F32_RATIO_MEDIAN}, each leaf {F32_RATIO_LEAF})", flush=True)
    _require(max(rel) <= LOSS_RTOL, f"3-step losses differ: {lk} vs {lp}")
    _require(cos[lo] >= GRAD_FLOOR, f"step-0 gradient {lo} cosine {cos[lo]} < {GRAD_FLOOR}")
    _require(med(ratio) <= F32_RATIO_MEDIAN,
             f"step-0 gradients: median distance ratio to strict f32 {med(ratio)} > {F32_RATIO_MEDIAN}")
    _require(not far, f"step-0 gradient leaves over {F32_RATIO_LEAF}x the plain path's "
                      f"distance to strict f32: {far[:3]}")


# every kernel of a swin_mlp_bwd / swin_attn_bwd call is named swin_mlp_bwd_* /
# swin_attn_bwd_* (csrc/swin_*_bwd.cu): those prefixes come first
SWIN_GROUPS = {"swin_attn_bwd": "swin_attn_bwd_", "swin_mlp_bwd": "swin_mlp_bwd_",
               **{k: k + "_kernel" for k in ("swin_wgrad", "swin_reduce", "swin_attn", "swin_mlp")}}
# the grid launches of one swin_mlp_bwd (also vit_mlp_bwd) and one
# swin_attn_bwd call by kernel name
MLP_BWD_LAUNCHES = {"chunk": "swin_mlp_bwd_chunk_kernel", "dm": "swin_mlp_bwd_mm_kernel",
                    "rows": "swin_mlp_bwd_rows_kernel"}
SWIN_ATTN_BWD_LAUNCHES = {"W_proj by head": "swin_attn_bwd_wpt_kernel",
                          "window": "swin_attn_bwd_window_kernel", "dh": "swin_attn_bwd_mm_kernel",
                          "rows": "swin_attn_bwd_rows_kernel"}
VIT_GROUPS = {"vit_qkv": "vit_qkv_kernel", "vit_attn": "vit_attn_kernel",
              "vit_proj": "vit_proj_kernel", "vit_mlp": "swin_mlp_kernel"}
# vit_attn_bwd's six grid launches by kernel name (csrc/vit_attn_bwd.cu)
ATTN_BWD_LAUNCHES = {"qkv": "vit_attn_bwd_qkv_kernel", "do": "vit_attn_bwd_mm_kernel<1>",
                     "query pass": "vit_attn_bwd_q_kernel", "key pass": "vit_attn_bwd_kv_kernel",
                     "dh": "vit_attn_bwd_mm_kernel<0>", "rows": "vit_attn_bwd_rows_kernel"}


PAD_CYCLES = 50_000_000  # ~25 ms of spin kernel at the H100's clock
PROFILE_TRIES = 3  # a process past the profiler's window fails every try


def _trace_rows(fn, n: int) -> list:
    """One torch.profiler trace of n calls of fn between two spin kernels:
    (key, count, self device us) of each device row."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(PAD_CYCLES)
        for _ in range(n):
            fn()
        torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        us = getattr(e, "self_device_time_total", None)
        rows.append((e.key, e.count, e.self_cuda_time_total if us is None else us))
    return rows


def _device_ms(fn, n: int = 2, groups_by=None) -> dict:
    """Device time of fn by kernel group, from torch.profiler over n calls
    (ms a call): the kernels by name (groups_by: group -> kernel symbol, the
    swin kernels by default), everything else as "other".

    Some time into a process the trace loses device records (our kernels,
    cuBLAS's and the spin kernels alike, with no warning): a fresh process
    reads whole traces, the same process after 60 s of sleep none (PERF.md
    §7). So a spin kernel brackets the window, and a trace is used only
    when both spins are in it and the trace before it held the same
    kernels the same number of times; after PROFILE_TRIES traces without
    such a pair, the fullest is used and a line says so."""
    import torch

    groups_by = groups_by or SWIN_GROUPS
    fn()
    torch.cuda.synchronize()
    prev, best, whole = None, None, False
    for _ in range(PROFILE_TRIES):
        rows = _trace_rows(fn, n)
        spins = sum(c for k, c, _ in rows if "spin_kernel" in k)
        sig = sorted((k, c) for k, c, _ in rows if "spin_kernel" not in k)
        if best is None or sum(c for _, c in sig) > sum(c for _, c in best[1]):
            best = (rows, sig)
        if spins == 2 and sig == prev:
            best, whole = (rows, sig), True
            break
        prev = sig if spins == 2 else None
    if not whole:
        print(f"[profile] no two whole traces agreed in {PROFILE_TRIES} tries: the next "
              f"reading is the fullest trace's and may under-read", flush=True)
    groups = {k: 0.0 for k in (*groups_by, "other")}
    for key, _, us in best[0]:
        if "spin_kernel" in key:
            continue
        g = next((k for k, sym in groups_by.items() if sym in key), "other")
        groups[g] += us / 1e3 / n
    return groups


def _cp_profile(base, x1, x2, dev, _block_params, fused_swin_block_train, ct, steps):
    """Where one CP step's device time goes, all by torch.profiler: the step
    by kernel group, and within "everything else" the stage-3 plain float32
    blocks (forward and backward, both views) and the optimizer, each
    profiled alone; the idle share against the unprofiled step time."""
    import copy

    import torch

    model = copy.deepcopy(base)
    opt = steps.adam_with_epoch_decay(list(model.parameters()), 5)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    step = lambda: ct.train_step(model, opt, x1, x2, gen, torch.bfloat16, "kernel", 0.1)
    wall = _time_ms(step, iters=5, warm=1)
    groups = _device_ms(step)
    busy = sum(groups.values())
    enc = model.htsat
    ones = torch.ones(B_TRAIN, device=dev)
    xs = torch.randn(B_TRAIN, 8, 8, 768, device=dev, requires_grad=True)

    def stage3():
        for _ in range(2):  # two views
            y = xs
            for blk in enc.layers[3].blocks:
                bias = blk.rel_pos_bias()
                y = fused_swin_block_train(y, _block_params(blk, bias, torch.float32), None, 0,
                                           ones, ones, "autograd")
            y.sum().backward()

    s3 = sum(_device_ms(stage3).values())
    op = sum(_device_ms(opt.step).values())
    kern = busy - groups["other"]
    print(f"[cp profile] one step at B={B_TRAIN} on the train kernels: {wall:.2f} ms a step "
          f"unprofiled, device busy {busy:.2f} ms ({100 * (1 - busy / wall):.1f}% idle); train "
          f"kernels {kern:.2f} ms: " + ", ".join(f"{k} {v:.2f}" for k, v in groups.items()
                                                 if k != "other")
          + f"; everything else {groups['other']:.2f} ms: the stage-3 plain f32 blocks (fwd+bwd, "
          f"2 views) {s3:.2f} ms, the optimizer {op:.2f} ms, the rest (glue: bn0, resize, patch "
          f"embed, merges, projector, loss, layouts) {groups['other'] - s3 - op:.2f} ms", flush=True)


# ---------------------------------------------------------------------------
# the MAE towers (operaGT ViT-S, Audio-MAE ViT-B)
# ---------------------------------------------------------------------------

# (tower, C, heads, Np, n_real): the token counts of a clip, cls included,
# padded to a multiple of 16
VIT_TOWERS = (("operaGT", 384, 6, 1040, 1025), ("audiomae", 768, 12, 528, 513))


def _vit_work(B, Np, n_real, C, heads):
    """(bytes, operations) of one launch of vit_qkv, vit_attn, vit_proj and
    vit_mlp on B clips of Np tokens of which n_real are real: each input
    read once, each output written once, over the B n_real real token rows
    only (the padded rows' outputs are thrown away and their keys masked);
    the attention core over n_real queries and n_real keys a head. vit_attn
    reads q, k, v and writes o_pre; vit_proj reads o_pre, x and the weights
    and writes out. Np is the padded count the launch runs at (unused)."""
    n = B * n_real
    qkv = 2 * n * C + 2 * 3 * C * C + 4 * 5 * C + 2 * 3 * n * C, 6 * n * C * C
    attn = 2 * 3 * n * C + 2 * n * C, 4 * B * heads * n_real * n_real * (C // heads)
    proj = 2 * n * C + 2 * n * C + 2 * C * C + 4 * C + 2 * n * C, 2 * n * C * C
    mlp = 4 * n * C + 16 * C * C + 4 * 7 * C, 16 * n * C * C
    return {"vit_qkv": qkv, "vit_attn": attn, "vit_proj": proj, "vit_mlp": mlp}


def _vit_params(C, heads, dev, seed):
    """One random ViT block at a tower's width, laid out for the kernels."""
    import torch

    from heart_murmur_detection_tpu_torch.ops import vit

    g = torch.Generator(device="cpu").manual_seed(seed)
    f = lambda *sh: torch.randn(*sh, generator=g) * 0.05
    sd = {"norm1.weight": 1 + f(C), "norm1.bias": f(C), "attn.qkv.weight": f(3 * C, C) * 2,
          "attn.qkv.bias": f(3 * C), "attn.proj.weight": f(C, C), "attn.proj.bias": f(C),
          "norm2.weight": 1 + f(C), "norm2.bias": f(C), "mlp.fc1.weight": f(4 * C, C),
          "mlp.fc1.bias": f(4 * C), "mlp.fc2.weight": f(C, 4 * C), "mlp.fc2.bias": f(C)}
    return vit.prep_vit_block(sd, heads, torch.bfloat16, dev)


def phase_vit_kernels(dev):
    """Each ViT kernel vs its plain version at both towers' shapes (B=16),
    both softmax modes. Returns {name: measurement} summed over one operaGT
    forward's 12 launches of each kernel at B=16 in the served (stable)
    softmax mode, which the kernels JSON reports: vit_attn is the attention
    core (its library call SDPA on the same q, k, v), vit_proj the proj,
    bias and residual (torch.addmm and the residual add)."""
    import torch

    from heart_murmur_detection_tpu_torch.bench.swin_fwd_time import mlp_chain
    from heart_murmur_detection_tpu_torch.ops import vit

    B = B_KERNEL
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "err": 0.0, "work": Work(), "library_ms": None}
           for k in ("vit_qkv", "vit_attn", "vit_proj", "vit_mlp")}
    for tower, C, heads, Np, n_real in VIT_TOWERS:
        p = _vit_params(C, heads, dev, SEED + C)
        g = torch.Generator(device="cpu").manual_seed(SEED + 10)
        x = (torch.randn(B, Np, C, generator=g) * 0.5).to(dev, torch.bfloat16)
        x[:, n_real:] = 0.0  # the padded rows of a first block
        work = _vit_work(B, Np, n_real, C, heads)
        bounds = {}
        for k, w in work.items():
            bounds[k] = Work()
            bounds[k].add(*w)
        qkv, ln1 = vit.vit_qkv(x, p, return_ln=True)
        qkv_ref = vit.vit_qkv_ref(x, p)
        torch.cuda.synchronize()
        c = _cos(qkv.float().cpu(), qkv_ref.float().cpu())
        c_ln = _cos(ln1.float().cpu(), vit.ln1_rows(x, p).float().cpu())
        same = torch.equal(qkv, vit.vit_qkv(x, p))
        err = float((qkv.float() - qkv_ref.float()).abs().max())
        k_ms = _time_ms(lambda: vit.vit_qkv(x, p))
        p_ms = _time_ms(lambda: vit.vit_qkv_ref(x, p), iters=5, warm=1)
        h = vit._ln(x, p.ln1_w, p.ln1_b, vit.LN_EPS).to(torch.bfloat16).reshape(-1, C)
        bq = p.b_qkv.to(torch.bfloat16)
        l_ms = _time_ms(lambda: torch.addmm(bq, h, p.w_qkv.t()))
        print(f"[vit kernel] vit_qkv {tower} C={C} Np={Np} B={B}: cos {c:.7f} max|d| {err:.4g}, "
              f"its LN1 output cos {c_ln:.7f}; bitwise repeatable {same}; kernel {k_ms:.4f} ms "
              f"plain {p_ms:.4f} ms bound {bounds['vit_qkv'].bound_ms:.4f} ms "
              f"({bounds['vit_qkv'].bound_by}); addmm on the LN output {l_ms:.4f} ms", flush=True)
        _require(min(c, c_ln) >= KERNEL_BAR and same,
                 f"vit_qkv {tower}: cosine {c}, LN1 output {c_ln}, repeatable {same}")
        meas = {"vit_qkv": (k_ms, p_ms, err, l_ms)}
        q, kk, vv = qkv_ref[0], qkv_ref[1][:, :, :n_real], qkv_ref[2][:, :, :n_real]
        sdpa_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kk, vv, scale=1.0))
        for mode in ("stable", "fast"):
            # the core alone against its plain version, then the pair
            # against the plain attention half
            o = vit.vit_attn(qkv_ref, p, n_real, mode)
            o_ref = vit.vit_attn_core_ref(qkv_ref, p, n_real, mode)
            got = vit.vit_proj(o, x, p)
            want = vit.vit_attn_out_ref(x, qkv_ref, p, n_real, mode)
            torch.cuda.synchronize()
            co = _cos(o.float().cpu(), o_ref.float().cpu())
            c = _branch(got, want, x)
            same = (torch.equal(o, vit.vit_attn(qkv_ref, p, n_real, mode))
                    and torch.equal(got, vit.vit_proj(o, x, p)))
            err = float((o.float() - o_ref.float()).abs().max())
            k_ms = _time_ms(lambda: vit.vit_attn(qkv_ref, p, n_real, mode))
            p_ms = _time_ms(lambda: vit.vit_attn_core_ref(qkv_ref, p, n_real, mode), iters=5,
                            warm=1)
            print(f"[vit kernel] vit_attn {tower} C={C} Np={Np} n_real={n_real} B={B} {mode} "
                  f"softmax: o_pre cos {co:.7f} max|d| {err:.4g}, with vit_proj branch cos "
                  f"{c:.7f}; bitwise repeatable {same}; kernel {k_ms:.4f} ms plain {p_ms:.4f} ms "
                  f"bound {bounds['vit_attn'].bound_ms:.4f} ms ({bounds['vit_attn'].bound_by}); "
                  f"scaled_dot_product_attention (keys sliced to n_real) {sdpa_ms:.4f} ms "
                  f"({k_ms / sdpa_ms:.2f}x)", flush=True)
            _require(min(co, c) >= KERNEL_BAR and same,
                     f"vit_attn {tower} {mode}: o_pre cosine {co}, branch cosine {c}, "
                     f"repeatable {same}")
            if mode == "stable":
                meas["vit_attn"] = (k_ms, p_ms, err, sdpa_ms)
                h1 = vit.vit_attn_out_ref(x, qkv_ref, p, n_real)
                o_s = o_ref
        got, want = vit.vit_proj(o_s, x, p), vit.vit_proj_ref(o_s, x, p)
        torch.cuda.synchronize()
        c = _branch(got, want, x)
        same = torch.equal(got, vit.vit_proj(o_s, x, p))
        err = float((got.float() - want.float()).abs().max())
        k_ms = _time_ms(lambda: vit.vit_proj(o_s, x, p))
        p_ms = _time_ms(lambda: vit.vit_proj_ref(o_s, x, p), iters=5, warm=1)
        o2, x2, bp = o_s.reshape(-1, C), x.reshape(-1, C), p.b_proj.to(torch.bfloat16)
        l_ms = _time_ms(lambda: torch.addmm(bp, o2, p.w_proj.t()).add_(x2))
        print(f"[vit kernel] vit_proj {tower} C={C} Np={Np} B={B}: branch cos {c:.7f} max|d| "
              f"{err:.4g}; bitwise repeatable {same}; kernel {k_ms:.4f} ms plain {p_ms:.4f} ms "
              f"bound {bounds['vit_proj'].bound_ms:.4f} ms ({bounds['vit_proj'].bound_by}); "
              f"torch.addmm + residual {l_ms:.4f} ms", flush=True)
        _require(c >= KERNEL_BAR and same, f"vit_proj {tower}: branch cosine {c}, repeatable {same}")
        meas["vit_proj"] = (k_ms, p_ms, err, l_ms)
        got, want = vit.vit_mlp(h1, p), vit.vit_mlp_ref(h1, p)
        torch.cuda.synchronize()
        c = _branch(got, want, h1)
        same = torch.equal(got, vit.vit_mlp(h1, p))
        err = float((got.float() - want.float()).abs().max())
        k_ms = _time_ms(lambda: vit.vit_mlp(h1, p))
        p_ms = _time_ms(lambda: vit.vit_mlp_ref(h1, p), iters=5, warm=1)
        c_ms = _time_ms(mlp_chain(h1, p, vit.LN_EPS))
        bm = bounds["vit_mlp"]
        print(f"[vit kernel] vit_mlp {tower} C={C} Np={Np} B={B}: branch cos {c:.7f} max|d| "
              f"{err:.4g}; bitwise repeatable {same}; kernel {k_ms:.4f} ms plain {p_ms:.4f} ms "
              f"bound {bm.bound_ms:.4f} ms ({bm.bound_by}, {bm.bound_ms / k_ms:.1%} of it); no "
              f"one-call library equivalent; library chain (layer_norm, addmm, gelu, addmm, "
              f"add) {c_ms:.4f} ms", flush=True)
        _require(c >= KERNEL_BAR and same, f"vit_mlp {tower}: branch cosine {c}, repeatable {same}")
        meas["vit_mlp"] = (k_ms, p_ms, err, None)
        if tower == "operaGT":  # the served path's shape: 12 launches a forward
            for k, (k_ms, p_ms, err, l_ms) in meas.items():
                tot[k]["ms"] = 12 * k_ms
                tot[k]["plain_ms"] = 12 * p_ms
                tot[k]["err"] = err
                tot[k]["library_ms"] = None if l_ms is None else 12 * l_ms
                tot[k]["work"].add(*work[k], n=12)
    return tot


def _vit_counts_ok(counts: dict, batches: int, depth: int) -> bool:
    return (counts["vit_qkv"] == counts["vit_attn"] == counts["vit_proj"] == counts["vit_mlp"]
            == depth * batches)


def phase_gt_serving(paths, device="cuda"):
    """A full-width random-init operaGT server on the 20 WAVs."""
    import numpy as np

    from heart_murmur_detection_tpu_torch.cli.serve import make_server
    from heart_murmur_detection_tpu_torch.ops import vit

    vit.reset_launch_counts()  # just before the main path
    t0 = time.time()
    srv = make_server({"pretrain": "operaGT", "batch_size": B_KERNEL, "random_init": True,
                       "device": device}, port=0)
    warm_s = time.time() - t0
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        code, body = _http(url + "/healthz")
        _require(code == 200 and body["status"] == "ok" and body["pretrain"] == "operaGT",
                 f"operaGT /healthz {code} {body}")
        t1 = time.time()
        code, body = _http(url + "/extract", json.dumps({"paths": paths}).encode(),
                           "application/json")
        served_s = time.time() - t1
        _require(code == 200, f"operaGT /extract paths -> {code}")
        feats = np.asarray(body["features"], np.float32)
        _require(feats.shape == (len(paths), 384) and bool(np.isfinite(feats).all()),
                 f"operaGT served shape {feats.shape} or non-finite")
        ex = srv.extractor
        offline = ex.extract_files(paths)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    counts = vit.launch_counts()
    batches = ex.n_dispatched
    chunks = [len(ex._chunks(p)) for p in paths]
    _require(np.allclose(feats, offline, atol=1e-5), "operaGT served != offline extract_files")
    depth = len(ex.model.blocks)
    _require(_vit_counts_ok(counts, batches, depth),
             f"operaGT launch counts {counts} for {batches} batches (want {depth} of each a batch)")
    _require(max(chunks) > 1, f"no clip split into several chunks: {chunks}")
    print(f"[gt serve] input_sec {ex.input_sec} s; 200s; features {feats.shape} finite; served "
          f"== offline; {sum(chunks)} chunks ({min(chunks)}-{max(chunks)} a clip); launches "
          f"{counts} over {batches} batches ({depth} of each); warm {warm_s:.1f} s; "
          f"{len(paths)}-clip request {served_s:.2f} s", flush=True)
    return ex, offline, counts


def phase_audiomae(paths, device="cuda"):
    """Offline audiomae extraction of the 20 WAVs on the kernels."""
    import numpy as np

    from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor
    from heart_murmur_detection_tpu_torch.ops import vit

    ex = FeatureExtractor("audiomae", input_sec=10, batch_size=B_KERNEL, random_init=True,
                          seed=SEED, device=device)
    vit.reset_launch_counts()  # just before the main path
    t0 = time.time()
    feats = ex.extract_files(paths)
    dt = time.time() - t0
    counts = vit.launch_counts()
    batches = ex.n_dispatched
    chunks = [len(ex._chunks(p)) for p in paths]
    _require(feats.shape == (len(paths), 768) and bool(np.isfinite(feats).all()),
             f"audiomae features {feats.shape} or non-finite")
    depth = len(ex.model.blocks)
    _require(_vit_counts_ok(counts, batches, depth),
             f"audiomae launch counts {counts} for {batches} batches (want {depth} of each a batch)")
    print(f"[audiomae] offline extract_files (fast_softmax {ex.fast_softmax}): features "
          f"{feats.shape} finite; {sum(chunks)} chunks ({min(chunks)}-{max(chunks)} a clip); "
          f"launches {counts} over {batches} batches ({depth} of each); {dt:.2f} s (first "
          f"batch included)", flush=True)
    return ex, feats


def _mae_reference_fn(ex, mm_dtype):
    """The extractor's batch forward with the ViT blocks on their plain
    versions."""
    import torch

    from heart_murmur_detection_tpu_torch.audio import dsp
    from heart_murmur_detection_tpu_torch.models.vit_fused import (
        audiomae_backbone_fused, mae_forward_feature_fused)

    def fn(wav, lengths):
        with torch.inference_mode():
            w, lengths = ex._prologue(wav, lengths)
            if ex.is_audiomae:
                fb, _ = dsp.kaldi_fbank_frontend(w, lengths)
                return audiomae_backbone_fused(ex.model, fb, mm_dtype, ex.fast_softmax, "plain")
            mel, _ = ex._mel(w, lengths)
            return mae_forward_feature_fused(ex.model, mel[:, :256], mm_dtype, ex.fast_softmax,
                                             "plain")

    return fn


def phase_mae_numerics(tower, ex, paths, feats):
    import torch

    def run(mm_dtype):
        old = ex._fn
        ex._fn = _mae_reference_fn(ex, mm_dtype)
        try:
            return ex.extract_files(paths)
        finally:
            ex._fn = old

    c_same = _cos(feats, run(torch.bfloat16))
    c_f32 = _cos(feats, run(torch.float32))
    print(f"[numerics] {tower} (fast_softmax {ex.fast_softmax}): cosine vs plain bf16 flow "
          f"{c_same:.7f} (bar {SAME_ROUNDING_BAR}); vs strict f32 plain, TF32 off {c_f32:.7f} "
          f"(bar {F32_BAR})", flush=True)
    _require(c_same >= SAME_ROUNDING_BAR, f"{tower} vs plain bf16 flow cosine {c_same}")
    _require(c_f32 >= F32_BAR, f"{tower} vs strict float32 path cosine {c_f32}")


def phase_mae_throughput(tower, ex, B, sec, smi):
    """Device-resident chunks/s of one tower, kernel path in both softmax
    modes and plain bf16 path; a profile of one kernel-path batch."""
    import torch

    dev = ex.device
    n = int(sec * 16000)
    npad = (n + 511) // 512 * 512
    g = torch.Generator(device="cpu").manual_seed(SEED + 11)
    wav = torch.zeros(B, npad, dtype=torch.int16)
    wav[:, :n] = (torch.randn(B, n, generator=g) * 3000).to(torch.int16)
    wav, lengths = wav.to(dev), torch.full((B,), n, dtype=torch.int32, device=dev)
    kern = {fast: ex._build(fast_softmax=fast) for fast in (False, True)}
    plain = _mae_reference_fn(ex, torch.bfloat16)
    k_ms = {fast: _time_ms(lambda: fn(wav, lengths), iters=10, warm=2) for fast, fn in kern.items()}
    p_ms = _time_ms(lambda: plain(wav, lengths), iters=3, warm=1)
    C, heads, Np, n_real = next(t[1:] for t in VIT_TOWERS if t[0] == tower)
    bound = Work()
    for w in _vit_work(B, Np, n_real, C, heads).values():
        bound.add(*w, n=12)
    groups = _device_ms(lambda: kern[False](wav, lengths), groups_by=VIT_GROUPS)
    busy = sum(groups.values())
    wall = k_ms[False]
    print(f"[throughput] {tower} {smi}: device-resident {sec}-s chunks B={B}: kernel path stable "
          f"{k_ms[False]:.2f} ms/batch = {B * 1000 / k_ms[False]:.1f} chunks/s, fast softmax "
          f"{k_ms[True]:.2f} ms = {B * 1000 / k_ms[True]:.1f} chunks/s; plain bf16 path "
          f"{p_ms:.2f} ms/batch = {B * 1000 / p_ms:.1f} chunks/s; the 48 block launches' bound "
          f"{bound.bound_ms:.3f} ms ({bound.bound_by})", flush=True)
    print(f"[profile] {tower} one stable batch B={B}: {wall:.2f} ms unprofiled, device busy "
          f"{busy:.2f} ms ({100 * (1 - busy / wall):.1f}% idle): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in groups.items() if k != "other")
          + f", glue (wire decode, {'fbank' if ex.is_audiomae else 'mel'}, patch embed, pads, "
          f"pooling, LN) {groups['other']:.2f} ms", flush=True)


def phase_mae(paths, smi, dev):
    """Phases 9-13: the ViT kernels, the served operaGT tower, the audiomae
    tower, their numerics and throughput."""
    import torch

    vit_meas = phase_vit_kernels(dev)
    gt, gt_feats, gt_counts = phase_gt_serving(paths, str(dev))
    phase_mae_numerics("operaGT", gt, paths, gt_feats)
    am, am_feats = phase_audiomae(paths, str(dev))
    phase_mae_numerics("audiomae", am, paths, am_feats)
    phase_mae_throughput("operaGT", gt, 64, 8.18, smi)
    del gt
    torch.cuda.empty_cache()
    phase_mae_throughput("audiomae", am, 32, 10, smi)
    del am
    torch.cuda.empty_cache()
    return vit_meas, gt_counts


# ---------------------------------------------------------------------------
# MAE continued pretraining (the ViT train kernels, K9)
# ---------------------------------------------------------------------------

# (tag, C, heads, Np, n_real, B): the CP shapes of Audio-MAE (1024 frames)
# and of OPERA-GT at max_len 256 and 64, the cls token included, padded to
# a multiple of 16; and once the operaGT fine-tuning shape
VIT_TRAIN_SHAPES = (("audiomae", 768, 12, 160, 154, B_TRAIN), ("mae", 384, 6, 320, 308, B_TRAIN),
                    ("mae short", 384, 6, 80, 77, B_TRAIN),
                    ("operaGT fine-tune", 384, 6, 1040, 1025, 4))
# a per-head constant added to every logit of a softmax row: its exact
# gradient is 0, so every path gives float noise there
ZERO_GRAD = ("attn.meta_mlp.fc2.bias",)


def _vit_bwd_work(B, Np, n_real, C, heads):
    """The shares of K9's backward function, one block of B clips of Np
    tokens: (bytes, operations) of vit_mlp_bwd, of vit_attn_bwd and of the
    weight products. MLP half: h1, dy and its weights in, dh1 out; the fc1
    recompute and two data products (24 n C^2). Attention half: x, dh1 and
    its weights in, dx out; the qkv recompute and the do and dh products
    (14 n C^2), and six attention products over the n_real real keys of
    each query (S, P V, dP, dq, dk, dv). Weight products: 24 n C^2 and the
    float32 gradients written once. The operand rows and partials that the
    design moves between the kernels are in no bound."""
    n, hid, hd = B * Np, 4 * C, C // heads
    mlp = 6 * n * C + 4 * hid * C + 4 * (3 * C + hid), 6 * n * C * hid
    attn = (6 * n * C + 8 * C * C + 4 * 6 * C,
            14 * n * C * C + 12 * B * heads * Np * n_real * hd)
    wgrad = 4 * 12 * C * C, 24 * n * C * C
    return mlp, attn, wgrad


def _leaf_grads(impl, x, sd, heads, n_real, w_out):
    """fused_vit_block_train on x with float32 leaves sd: (y, {leaf: grad})."""
    import torch

    from heart_murmur_detection_tpu_torch.ops import vit
    from heart_murmur_detection_tpu_torch.ops.vit_train import fused_vit_block_train

    leaves = {q: v.clone().requires_grad_() for q, v in sd.items()}
    xi = x.clone().requires_grad_()
    p = vit.vit_block_layout(lambda q: leaves[q], heads, torch.bfloat16)
    y = fused_vit_block_train(xi, p, n_real, impl)
    g = torch.autograd.grad((y[:, :n_real].float() * w_out).sum(), [xi, *leaves.values()])
    return y.detach(), dict(zip(["x", *leaves], g))


def phase_vit_train_kernels(dev):
    """Phase 14: the ViT backward kernels vs their plain versions at the CP
    shapes, and fused_vit_block_train against impl="plain". Returns
    {name: measurement} over one Audio-MAE CP step (12 blocks at B=64) for
    vit_attn_bwd, vit_mlp_bwd and that step's swin_wgrad / swin_reduce."""
    import torch

    from heart_murmur_detection_tpu_torch.bench.swin_bwd_time import mlp_bwd_chain
    from heart_murmur_detection_tpu_torch.bench.vit_bwd_time import library_chain
    from heart_murmur_detection_tpu_torch.ops import swin_train as st
    from heart_murmur_detection_tpu_torch.ops import vit
    from heart_murmur_detection_tpu_torch.ops import vit_train as vt

    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "err": 0.0, "work": Work(),
               "library_ms": None if k == "vit_mlp_bwd" else 0.0}
           for k in ("vit_attn_bwd", "vit_mlp_bwd", "swin_wgrad", "swin_reduce")}
    for tag, C, heads, Np, n_real, B in VIT_TRAIN_SHAPES:
        p = _vit_params(C, heads, dev, SEED + 20 + Np)
        g = torch.Generator(device="cpu").manual_seed(SEED + 21 + Np)
        x = (torch.randn(B, Np, C, generator=g) * 0.5).to(dev, torch.bfloat16)
        dy = (torch.randn(B, Np, C, generator=g) * 0.1).to(dev, torch.bfloat16)
        dy[:, n_real:] = 0  # the caller's y[:, :n_real] slice
        h1 = vit.vit_attn_ref(x, p, n_real)
        shape = f"{tag} B={B} Np={Np} n_real={n_real} C={C}"
        # the two halves: the wrappers twice (bitwise), the launch for the rows
        (d1, g1), (d2, g2) = vt.vit_mlp_bwd(h1, dy, p), vt.vit_mlp_bwd(h1, dy, p)
        _, mrow, part_m = vt.vit_mlp_bwd_launch(h1, dy, p)
        dh1, gm, mref = vt.vit_mlp_bwd_ref(h1, dy, p, rows=True)
        (a1, ga1), (a2, ga2) = vt.vit_attn_bwd(x, dh1, p, n_real), vt.vit_attn_bwd(x, dh1, p, n_real)
        _, arow, part_a = vt.vit_attn_bwd_launch(x, dh1, p, n_real)
        dx, ga, aref = vt.vit_attn_bwd_ref(x, dh1, p, n_real, rows=True)
        torch.cuda.synchronize()
        # dqkv's thirds apart: dq (query pass), dk and dv (key pass)
        arow_3 = (*arow[:2], *arow[2].reshape(-1, 3, C).unbind(1))
        aref_3 = (*aref[:2], *aref[2].reshape(-1, 3, C).unbind(1))
        pad_kv = not bool(arow[2].reshape(B, Np, 3, C)[:, n_real:, 1:].any())
        _require(pad_kv, f"vit_attn_bwd {shape}: dk / dv rows of the padded keys are not 0")
        for what, d_1, d_2, gg1, gg2, want_d, base, want_g, rows, ref_rows, names in (
            ("vit_mlp_bwd", d1, d2, g1, g2, dh1, dy, gm, mrow, mref, ("LN2(h1)", "GELU(a1)", "da1")),
            ("vit_attn_bwd", a1, a2, ga1, ga2, dx, dh1, ga, arow_3, aref_3,
             ("LN1(x)", "o_pre", "dq", "dk", "dv")),
        ):
            same = torch.equal(d_1, d_2) and all(torch.equal(gg1[q], gg2[q]) for q in gg1)
            _require(same, f"{what} {shape}: two launches differ")
            cos = {"d_in branch": _branch(d_1, want_d, base)}
            cos.update({f"row {n}": _cos(a.float().cpu(), b.float().cpu())
                        for n, a, b in zip(names, rows, ref_rows)})
            cos.update({q: _cos(gg1[q].cpu(), want_g[q].cpu()) for q in want_g})
            err = float((d_1.float() - want_d.float()).abs().max())
            pad0 = not bool(d_1[:, n_real:].any())
            lo = min(cos, key=cos.get)
            print(f"[vit train bwd] {what} {shape}: bitwise repeatable; padded rows of the input "
                  f"gradient exactly 0: {pad0}; max|d| {err:.4g}; cosines "
                  + " ".join(f"{q} {v:.7f}" for q, v in cos.items()), flush=True)
            _require(cos[lo] >= KERNEL_BAR, f"{what} {shape}: {lo} cosine {cos[lo]} < {KERNEL_BAR}")
            _require(pad0, f"{what} {shape}: padded rows of the input gradient are not 0")
            if tag == "audiomae":
                tot[what]["err"] = err
        # the whole Function, forward and backward, against impl="plain"
        r = torch.Generator(device="cpu").manual_seed(SEED + 22 + Np)
        f = lambda *sh: (torch.randn(*sh, generator=r) * 0.05).to(dev)
        sd = {"norm1.weight": 1 + f(C), "norm1.bias": f(C), "attn.qkv.weight": f(3 * C, C) * 2,
              "attn.qkv.bias": f(3 * C), "attn.proj.weight": f(C, C), "attn.proj.bias": f(C),
              "norm2.weight": 1 + f(C), "norm2.bias": f(C), "mlp.fc1.weight": f(4 * C, C),
              "mlp.fc1.bias": f(4 * C), "mlp.fc2.weight": f(C, 4 * C), "mlp.fc2.bias": f(C)}
        w_out = f(B, n_real, C) * 20
        yk, gk = _leaf_grads("kernel", x, sd, heads, n_real, w_out)
        yp, gp = _leaf_grads("plain", x, sd, heads, n_real, w_out)
        torch.cuda.synchronize()
        cos = {"y branch": _branch(yk[:, :n_real], yp[:, :n_real], x[:, :n_real])}
        cos.update({q: _cos(gk[q].float().cpu(), gp[q].float().cpu()) for q in gp})
        lo = min(cos, key=cos.get)
        print(f"[vit train block] fused_vit_block_train {shape}, kernel vs plain: min cosine "
              f"{cos[lo]:.7f} ({lo}) over the output branch and {len(gp)} gradients", flush=True)
        _require(cos[lo] >= KERNEL_BAR, f"fused_vit_block_train {shape}: {lo} cosine {cos[lo]}")
        # a launch of each half, the plain halves, and SDPA's backward on the
        # same q, k, v and dO (the attention core alone, a yardstick)
        mb_ms = _time_ms(lambda: vt.vit_mlp_bwd_launch(h1, dy, p), iters=10, warm=2)
        ab_ms = _time_ms(lambda: vt.vit_attn_bwd_launch(x, dh1, p, n_real), iters=10, warm=2)
        mp_ms = _time_ms(lambda: vt.vit_mlp_bwd_ref(h1, dy, p), iters=3, warm=1)
        ap_ms = _time_ms(lambda: vt.vit_attn_bwd_ref(x, dh1, p, n_real), iters=3, warm=1)
        qkv = vit.vit_qkv_ref(x, p)
        q = qkv[0].detach().requires_grad_()
        k = qkv[1][:, :, :n_real].detach().requires_grad_()
        v = qkv[2][:, :, :n_real].detach().requires_grad_()
        o = torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=1.0)
        do = torch.randn(o.shape, generator=r).to(dev, o.dtype)
        lib_ms = _time_ms(lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True),
                          iters=10, warm=2)
        # the whole function as library calls (bench/vit_bwd_time.py), and
        # the device time of each of vit_attn_bwd's grid launches by name
        chain, _ = library_chain(x, dh1, p, n_real)
        chain_ms = _time_ms(chain, iters=10, warm=2)
        split = _device_ms(lambda: vt.vit_attn_bwd_launch(x, dh1, p, n_real),
                           groups_by=ATTN_BWD_LAUNCHES)
        mchain_ms = _time_ms(mlp_bwd_chain(h1, dy, None, p, vit.LN_EPS), iters=10, warm=2)
        msplit = _device_ms(lambda: vt.vit_mlp_bwd_launch(h1, dy, p), groups_by=MLP_BWD_LAUNCHES)
        print(f"[vit train kernels] {shape}: vit_attn_bwd's function as library calls "
              f"(layer_norm, addmm, mm, SDPA backward, mm, the LayerNorm backward) "
              f"{chain_ms:.4f} ms; vit_attn_bwd's grid launches by the profiler (ms a call): "
              f"{ {k: round(v, 4) for k, v in split.items()} }; vit_mlp_bwd's function as a "
              f"library chain (autograd backward of layer_norm, linear, gelu, linear in bf16) "
              f"{mchain_ms:.4f} ms; its grid launches by the profiler (ms a call): "
              f"{ {k: round(v, 4) for k, v in msplit.items()} }", flush=True)
        (wm, om), (wa, oa), (ww, ow) = _vit_bwd_work(B, Np, n_real, C, heads)
        bm, ba, bw = Work(), Work(), Work()
        bm.add(wm, om)
        ba.add(wa, oa)
        bw.add(ww, ow)
        print(f"[vit train kernels] {shape}: a launch: vit_mlp_bwd {mb_ms:.4f} ms (bound "
              f"{bm.bound_ms:.4f}, {bm.bound_by}; plain half {mp_ms:.4f}), vit_attn_bwd "
              f"{ab_ms:.4f} ms (bound {ba.bound_ms:.4f}, {ba.bound_by}; plain half {ap_ms:.4f}; "
              f"scaled_dot_product_attention backward on the same q, k, v, dO {lib_ms:.4f}); "
              f"the block's weight products bound {bw.bound_ms:.4f} ms ({bw.bound_by})", flush=True)
        if tag != "audiomae":
            continue
        # one Audio-MAE CP step: 12 blocks
        for what, ms, pms, wk in (("vit_mlp_bwd", mb_ms, mp_ms, (wm, om)),
                                  ("vit_attn_bwd", ab_ms, ap_ms, (wa, oa))):
            tot[what]["ms"] = 12 * ms
            tot[what]["plain_ms"] = 12 * pms
            tot[what]["work"].add(*wk, n=12)
        tot["vit_attn_bwd"]["library_ms"] = 12 * lib_ms
        n = B * Np
        m_g, g_g, da1_g = mrow
        h_g, opre_g, dqkv_g = arow
        for a_, b_ in ((da1_g, m_g), (dy.reshape(n, C), g_g), (dqkv_g, h_g),
                       (dh1.reshape(n, C), opre_g)):
            got, want = st.swin_wgrad(a_, b_), st.wgrad_ref(a_, b_)
            torch.cuda.synchronize()
            c = _cos(got.cpu(), want.cpu())
            _require(c >= KERNEL_BAR and torch.equal(got, st.swin_wgrad(a_, b_)),
                     f"swin_wgrad {shape} {tuple(a_.shape)} x {tuple(b_.shape)}: cosine {c}")
            M, N = got.shape
            S, chunk = st.wgrad_split(n, M, N)
            w_ms = _time_ms(lambda: st.swin_wgrad(a_, b_), iters=10, warm=2)
            l_ms = _time_ms(lambda: torch.mm(a_.t(), b_), iters=10, warm=2)
            tot["swin_wgrad"]["ms"] += 12 * w_ms
            tot["swin_wgrad"]["plain_ms"] += 12 * _time_ms(lambda: st.wgrad_ref(a_, b_), iters=3, warm=1)
            tot["swin_wgrad"]["library_ms"] += 12 * l_ms
            tot["swin_wgrad"]["work"].add(4 * M * N, 2 * n * M * N, n=12)
            tot["swin_wgrad"]["err"] = max(tot["swin_wgrad"]["err"], float((got - want).abs().max()))
            print(f"[vit train wgrad] {shape}: ({n}, {M}) x ({n}, {N}) in {S} chunks of {chunk}, "
                  f"one launch: cos {c:.7f}, bitwise repeatable; {w_ms:.4f} ms, torch.mm "
                  f"{l_ms:.4f} ms ({w_ms / l_ms:.2f}x)", flush=True)
        for part in (part_m, part_a):
            S, L = part.shape
            _require(torch.equal(st.swin_reduce(part), st.reduce_ref(part)),
                     f"swin_reduce {shape} ({S}, {L}) differs from the in-order sum")
            _reduce_row(tot["swin_reduce"], part, 12, shape)
        fn = Work()
        fn.add(wm + wa + ww, om + oa + ow)
        print(f"[vit train kernels] an Audio-MAE CP step (12 blocks at B={B}): K9's backward "
              f"function bound {12 * fn.bound_ms:.4f} ms ({fn.bound_by}); both column-sum "
              f"reductions a block equal to the in-order sum", flush=True)
    return tot


def _write_specs(root: str, corpora, seed: int):
    """Synthetic spectrogram corpora on disk: (manifest, clips, lo, hi,
    bins) each; clips of lo-hi frames x bins float32, the manifest listing
    them without .npy (the layouts pretrain/data.py's manifests name)."""
    import numpy as np

    r = np.random.default_rng(seed)
    for manifest, n, lo, hi, bins in corpora:
        d = os.path.join(os.path.dirname(manifest), "spec_" + os.path.basename(manifest)[:-4])
        os.makedirs(os.path.join(root, d), exist_ok=True)
        names = []
        for i, t in enumerate(r.integers(lo, hi + 1, n)):
            f = os.path.join(d, f"{i:04d}")
            np.save(os.path.join(root, f + ".npy"),
                    (r.standard_normal((int(t), bins)) * 10 - 40).astype(np.float32))
            names.append(f)
        np.save(os.path.join(root, manifest), np.asarray(names))


# Audio-MAE CP: three heart corpora (fbank clips of 600-1400 frames x 128);
# circor holds enough clips for one validation batch of 64 (drop_last)
AM_CORPORA = (("feature/circor_eval/audiomae_entire_spec_filenames.npy", 720, 600, 1400, 128),
              ("feature/physionet16_eval/audiomae_entire_spec_filenames.npy", 300, 600, 1400, 128),
              ("feature/pascal_A_eval/audiomae_entire_spec_filenames.npy", 300, 600, 1400, 128))
# MAE CP (OPERA-GT): two respiratory corpora at max_len 256 and 64 (mel clips
# x 64), each with one validation batch
GT_CORPORA = (("datasets/covid19-sounds/SSL_entireaudio_filenames_breath.npy", 720, 100, 400, 64),
              ("datasets/covid19-sounds/SSL_entireaudio_filenames_cough.npy", 720, 30, 120, 64))


def _all_counts():
    from heart_murmur_detection_tpu_torch.ops import mel, swin, vit
    from heart_murmur_detection_tpu_torch.ops import vit_train as vt

    return {**swin.launch_counts(), **vit.launch_counts(), **vt.launch_counts(),
            **mel.launch_counts()}


def _reset_counts():
    from heart_murmur_detection_tpu_torch.ops import mel, swin, vit
    from heart_murmur_detection_tpu_torch.ops import vit_train as vt

    for m in (swin, vit, vt, mel):
        m.reset_launch_counts()


def _mae_cli(root: str, method: str, corpora: tuple, fused_train: bool):
    """One epoch of MAE CP at B=64 through cli.pretrain in `root`; returns
    (history entry, launch counts of the run)."""
    from heart_murmur_detection_tpu_torch.cli import pretrain

    argv = [f"method={method}", "compute_dtype=bfloat16", "batch_size=64", "epoches=1",
            "seed=0", "title=smoke", "device=cuda", f"fused_train={fused_train}", *corpora]
    cwd = os.getcwd()
    os.chdir(root)
    try:
        _reset_counts()  # just before the main path
        ((_, history, _),) = pretrain.main(argv)
        counts = _all_counts()
    finally:
        os.chdir(cwd)
    return history[0], counts


def _mae_per_step(cfg) -> dict:
    """Backward launches of one MAE CP step: one of each backward kernel a
    block, four weight products a block (each one swin_wgrad launch), and
    one swin_reduce for each backward kernel's column sums."""
    d = cfg.depth
    return {"vit_attn_bwd": d, "vit_mlp_bwd": d, "swin_wgrad": 4 * d, "swin_reduce": 2 * d}


def _mae_cp_report(tag, h, counts, cfg, per_step, n_val):
    import math

    ok = all(counts[q] == v * h["steps"] for q, v in per_step.items())
    fwd = cfg.depth * (h["steps"] + n_val)
    ok &= (counts["vit_qkv"] == counts["vit_attn"] == counts["vit_proj"] == counts["vit_mlp"]
           == fwd)
    _require(ok, f"{tag} launch counts {counts} for {h['steps']} steps and {n_val} eval batches "
                 f"(want {per_step} a step and {cfg.depth} of each forward kernel a batch)")
    _require(all(math.isfinite(h[q]) for q in ("train_loss", "valid_loss")), f"{tag} losses {h}")
    print(f"{tag}: {h['steps']} steps, {h['samples']} samples in {h['train_seconds']:.2f} s "
          f"(first step included) = {h['steps'] / h['train_seconds']:.3f} steps/s, "
          f"{h['samples'] / h['train_seconds']:.1f} samples/s; train loss {h['train_loss']:.4f} "
          f"valid {h['valid_loss']:.4f}; launches {counts} ({per_step} a step)", flush=True)


def phase_mae_cp(smi: str, dev):
    """Phases 15-17: Audio-MAE CP through the CLI on the kernels and on the
    plain bf16 path with steady-state step times; MAE (OPERA-GT) CP on
    variable-length corpora; the Audio-MAE 3-step agreement and a profile of
    one step. Returns the launch counts of the Audio-MAE kernel-path epoch."""
    import copy

    import torch

    from heart_murmur_detection_tpu_torch.cli.pretrain import HEART_CORPORA
    from heart_murmur_detection_tpu_torch.models import vit_mae
    from heart_murmur_detection_tpu_torch.models.mae_train_fused import mae_train_loss_fused
    from heart_murmur_detection_tpu_torch.pretrain import steps
    from heart_murmur_detection_tpu_torch.pretrain.data import (
        OPTIMAL_MAX_LEN_MAE, MultiCorpusSampler, load_corpus)

    am_cfg = vit_mae.audiomae_base_config(mask_ratio=0.7)
    am_args = [f"{m.split('/')[1][:-5]}=True" for m, *_ in AM_CORPORA]
    assert all(a.split("=")[0] in HEART_CORPORA for a in am_args)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        _write_specs(root, AM_CORPORA, SEED + 30)
        print(f"[mae cp] Audio-MAE: 3 heart corpora ({sum(c[1] for c in AM_CORPORA)} fbank clips "
              f"of 600-1400 frames x 128) written in {time.time() - t0:.1f} s", flush=True)
        per_step = _mae_per_step(am_cfg)
        h, counts = _mae_cli(root, "audiomae", am_args, True)
        _mae_cp_report(f"[mae cp] cli.pretrain method=audiomae, train kernels, {smi}", h, counts,
                       am_cfg, per_step, 1)
        hp, cp = _mae_cli(root, "audiomae", am_args, False)
        _require(all(cp[q] == 0 for q in per_step), f"plain path launched kernels: {cp}")
        print(f"[mae cp] cli.pretrain method=audiomae, plain bf16 path: {hp['steps']} steps in "
              f"{hp['train_seconds']:.2f} s = {hp['samples'] / hp['train_seconds']:.1f} samples/s; "
              f"train loss {hp['train_loss']:.4f} valid {hp['valid_loss']:.4f}", flush=True)
        cwd = os.getcwd()
        os.chdir(root)
        try:
            corpora = [load_corpus(m.split("/")[1][:-5], 1024, "audiomae") for m, *_ in AM_CORPORA]
        finally:
            os.chdir(cwd)
    sampler = MultiCorpusSampler(corpora, B_TRAIN, "audiomae", seed=SEED + 31)
    batches = [torch.from_numpy(sampler.next_batch()[1]).to(dev) for _ in range(3)]
    del corpora, sampler
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    noises = [torch.rand(B_TRAIN, 512, generator=gen, device=dev) for _ in range(3)]
    base = vit_mae.MaskedAutoencoderViT(am_cfg, decoder=True)
    vit_mae.init_weights(base, torch.Generator().manual_seed(SEED))
    base.to(dev).train()

    # phase 15's steady state: a step on one batch, each path
    for impl in ("kernel", "plain"):
        model = copy.deepcopy(base)
        opt = steps.adam_with_epoch_decay(list(model.parameters()), 5)
        step = lambda: steps.mae_train_step(model, opt, batches[0], torch.bfloat16, impl, noises[0])
        ms = _time_ms(step, iters=3, warm=1)
        print(f"[mae cp] Audio-MAE steady state, {impl} path, B={B_TRAIN} x 1024 x 128: {ms:.2f} "
              f"ms/step = {1000 / ms:.3f} steps/s, {B_TRAIN * 1000 / ms:.1f} samples/s", flush=True)
        del model, opt

    # phase 16: OPERA-GT MAE CP on corpora of max_len 256 and 64
    gt_cfg = vit_mae.mae_vit_small_config(mask_ratio=0.7)
    with tempfile.TemporaryDirectory() as root:
        _write_specs(root, GT_CORPORA, SEED + 33)
        gt_args = ["covidbreath=True", "covidcough=True"]
        h16, c16 = _mae_cli(root, "mae", gt_args, True)
        lens = {n: OPTIMAL_MAX_LEN_MAE[n] for n in ("covidbreath", "covidcough")}
        with open(os.path.join(root, "cks", "logs", "combined", "smoke", "metrics.csv")) as f:
            row = f.read().splitlines()
        _mae_cp_report(f"[mae cp] cli.pretrain method=mae (max_len {lens}), train kernels", h16,
                       c16, gt_cfg, _mae_per_step(gt_cfg), 2)
        print(f"[mae cp] mae CSV: {row[0]} | {row[1]}", flush=True)
        cols = dict(zip(row[0].split(","), row[1].split(",")))
        _require(all(cols[f"train{s}_loss"] != "nan" for s in (0, 1)),
                 f"an epoch that did not draw both lengths: {cols}")

    # phase 17: 3 steps of each path from the same weights, batches and noise
    def run(impl, mm_dtype=torch.bfloat16, n_steps=3):
        model = copy.deepcopy(base)
        opt = steps.adam_with_epoch_decay(list(model.parameters()), 5)
        losses, grads = [], None
        for i, x in enumerate(batches[:n_steps]):
            opt.zero_grad()
            loss = mae_train_loss_fused(model, x, noises[i], None, mm_dtype, impl)
            loss.backward()
            if i == 0:
                grads = {q: w.grad.detach().clone() for q, w in model.named_parameters()}
            opt.step()
            losses.append(float(loss.detach()))
        return losses, grads

    lk, gk = run("kernel")
    lp, gp = run("plain")
    lf, gf = run("autograd", torch.float32, 1)
    zero = max(float(g[q].abs().max()) for g in (gk, gp, gf) for q in g if q.endswith(ZERO_GRAD))
    print(f"[mae cp] the meta-MLP output biases' gradients (exact value 0) read at most "
          f"{zero:.3g} in every path", flush=True)
    _step0_rule("[mae cp] Audio-MAE, 3 steps from the same weights, batches and masking noise",
                lk, lp, lf, gk, gp, gf, skip=ZERO_GRAD)
    del gk, gp, gf
    _mae_profile("Audio-MAE (1024 x 128)", base, batches[0], noises[0], steps)
    return counts


# every kernel of vit_attn_bwd's call, its LN1 + qkv recompute and its do /
# dh products too, is named vit_attn_bwd_* (csrc/vit_attn_bwd.cu), and every
# kernel of vit_mlp_bwd's swin_mlp_bwd_* (csrc/swin_mlp_bwd.cu): the _bwd_
# prefixes come before the forward kernels
MAE_GROUPS = {"vit_attn_bwd": "vit_attn_bwd_", "vit_mlp_bwd": "swin_mlp_bwd_", **VIT_GROUPS,
              "swin_wgrad": "swin_wgrad_kernel", "swin_reduce": "swin_reduce_kernel"}


def _mae_profile(tag, base, x, noise, steps):
    """Where one MAE CP step's device time goes (torch.profiler): the
    kernels by group; within everything else, the decoder (forward and
    backward from the encoder tokens) and the optimizer, each profiled
    alone; the glue (patch embed, masking, pads, LN, loss) is the rest; the
    idle share against the unprofiled step time."""
    import copy

    import torch

    from heart_murmur_detection_tpu_torch.models.mae_train_fused import mae_encode_train_fused

    model = copy.deepcopy(base)
    opt = steps.adam_with_epoch_decay(list(model.parameters()), 5)
    step = lambda: steps.mae_train_step(model, opt, x, torch.bfloat16, "kernel", noise)
    wall = _time_ms(step, iters=3, warm=1)
    groups = _device_ms(step, groups_by=MAE_GROUPS)
    busy = sum(groups.values())
    with torch.no_grad():
        h, mask, ids = mae_encode_train_fused(model, x, noise, None, torch.bfloat16, "kernel",
                                              train=False)

    def decoder():
        hi = h.clone().requires_grad_()
        model.masked_loss(x, model.forward_decoder(hi, ids, torch.bfloat16), mask).backward()

    dec = sum(_device_ms(decoder).values())
    op = sum(_device_ms(opt.step).values())
    kern = busy - groups["other"]
    print(f"[mae cp profile] one {tag} step at B={B_TRAIN} on the kernels: {wall:.2f} ms a step "
          f"unprofiled, device busy {busy:.2f} ms ({100 * (1 - busy / wall):.1f}% idle); encoder "
          f"kernels {kern:.2f} ms: " + ", ".join(f"{k} {v:.2f}" for k, v in groups.items()
                                                  if k != "other")
          + f"; everything else {groups['other']:.2f} ms: the plain-torch decoder (fwd+bwd) "
          f"{dec:.2f} ms, the optimizer {op:.2f} ms, the rest (glue: patch embed, masking, pads, "
          f"LN, loss) {groups['other'] - dec - op:.2f} ms", flush=True)


# ---------------------------------------------------------------------------
# the main path: log-mel kernel K4, source-rate extraction, the heart probe
# ---------------------------------------------------------------------------

# (name, B, seconds a clip; None = ragged 3-32 s): the operaCT serving batch
# of 10-s clips, the throughput batch, the whole-clip batch of cli.process
# (every clip padded to 32 s), the operaGT chunk batch and a ragged batch
LOGMEL_CASES = (("operaCT serve 10 s", 16, 10.0), ("operaCT throughput 10 s", 64, 10.0),
                ("operaCT cli.process 32 s", 16, 32.0), ("operaGT chunks 8.18 s", 64, 8.18),
                ("ragged 3-32 s", 16, None))
LOGMEL_MAIN = "operaCT cli.process 32 s"  # the kernels JSON row: the main path's launch shape
LOGMEL_ATOL = 1e-4  # normalised mel, kernel vs plain (both float32)
LOGMEL_F64_RATIO = 4.0  # kernel's error vs float64 over the plain float32 version's
RESAMPLE_ATOL = 3e-5  # tests/test_resample.py's bar
# source_sr vs the 16 kHz host path: the JAX package's own bar for the same
# comparison (tests/test_wire.py); the FIR's ringing past a clip's end stays
# in the padding, as in the JAX prologue, and moves the clip's last frames
SOURCE_SR_BAR = 0.999
CIRCOR_PATIENTS = 120
# phases 21 and 23 repeat phase 19's path from disk on a corpus of their own:
# half of its patients, for the smoke's time budget
REPEAT_PATIENTS = 60


def phase_logmel(smi: str):
    """Phase 18: the logmel kernel against its plain version at the main
    path's shapes, with times, bounds and the library call; the float64
    precision check. Returns its measurement for the kernels JSON."""
    from heart_murmur_detection_tpu_torch.bench import logmel_time as lt

    meas = None
    for i, (name, B, sec) in enumerate(LOGMEL_CASES):
        m = lt.measure(B, sec, seed=SEED + 40 + i)
        spread = lambda runs: f"{min(runs):.4f}-{max(runs):.4f}"  # noqa: E731
        print(f"[logmel] {name} B={B} N={m['N']}: frames equal {m['frames_equal']}, normalised "
              f"max|d| {m['max_abs_err']:.3g} (bar {LOGMEL_ATOL}), bitwise repeatable "
              f"{m['bitwise']}; in {len(m['ms_runs'])} turns, kernel median {m['ms']:.4f} ms "
              f"({spread(m['ms_runs'])}), torch.stft + power + mel product (two calls) median "
              f"{m['library_ms']:.4f} ms ({spread(m['library_runs'])}; log10 max|d| "
              f"{m['library_max_abs_log10']:.3g}), kernel / library "
              f"{m['ms'] / m['library_ms']:.3f}; plain {m['plain_ms']:.4f} ms; bound "
              f"{m['bound_ms']:.4f} ms ({m['bound_by']}: {m['bytes'] / 1e6:.1f} MB at the HBM "
              f"rate; the least work, a real FFT a frame, is {m['flops'] / 1e9:.3f} GFLOP at the "
              f"67 TFLOP/s float32 peak), the kernel at {100 * m['bound_ms'] / m['ms']:.2f}% of "
              f"it; the TPU kernel's dense DFT and mel products, {m['dense_flops'] / 1e9:.2f} "
              f"GFLOP, take {m['dense_ms']:.4f} ms at that peak (not a bound); {smi}", flush=True)
        _require(m["frames_equal"] and m["bitwise"], f"logmel {name}: frames or repeatability")
        _require(m["max_abs_err"] <= LOGMEL_ATOL, f"logmel {name}: max|d| {m['max_abs_err']}")
        if name == LOGMEL_MAIN:
            work = Work(F32_FLOPS)  # the least work: a real FFT a frame, float32
            work.add(m["bytes"], m["flops"])
            meas = {"ms": m["ms"], "plain_ms": m["plain_ms"], "err": m["max_abs_err"],
                    "work": work, "library_ms": m["library_ms"]}
    p = lt.precision()
    print(f"[logmel] float64 check, a 1e-3 tone plus 1e-5 noise: max|err| kernel "
          f"{p['kernel_err']:.3g}, plain float32 {p['plain_err']:.3g} (ratio {p['ratio']:.2f}, bar "
          f"{LOGMEL_F64_RATIO}); rms {p['kernel_rms']:.3g} vs {p['plain_rms']:.3g}", flush=True)
    _require(p["ratio"] <= LOGMEL_F64_RATIO, f"logmel float64 error ratio {p['ratio']}")
    return {"logmel": meas}


def _per_clip_cos(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _logmel_extract(pretrain: str, files, use_pallas_mel: bool, **kw):
    """Features of `files` through FeatureExtractor on the card, with the
    logmel and swin / ViT launches of that run; (features, counts, batches)."""
    from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor
    from heart_murmur_detection_tpu_torch.extract.registry import default_input_sec

    ex = FeatureExtractor(pretrain, dim=768, input_sec=default_input_sec(pretrain),
                          random_init=True, seed=SEED, pad0=True,
                          use_pallas_mel=use_pallas_mel, device="cuda", **kw)
    _reset_counts()
    feats = ex.extract_files(files)
    return feats, _all_counts(), ex.n_dispatched


def phase_main_path(smi: str):
    """Phase 19: the system's main path end to end on the card. A synthetic
    CirCor corpus at 4 kHz through cli.process (source_sr=4000: the clips
    ship at 4 kHz and the card upsamples them) and cli.linear_eval (5
    seeds); the same files with use_pallas_mel for operaCT and operaGT; the
    device upsample against scipy and the source-rate features against the
    16 kHz host path. Returns the logmel launches of its use_pallas_mel
    runs."""
    import numpy as np
    import torch
    from scipy.signal import resample_poly

    from heart_murmur_detection_tpu_torch.audio import pipelines
    from heart_murmur_detection_tpu_torch.bench.process_time import write_circor
    from heart_murmur_detection_tpu_torch.cli import linear_eval, process
    from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor
    from heart_murmur_detection_tpu_torch.utils.audio_io import load_wav

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        n_clips = write_circor(root, CIRCOR_PATIENTS, seed=SEED + 19)
        print(f"[main path] synthetic CirCor: {CIRCOR_PATIENTS} patients, {n_clips} clips of "
              f"6-32 s at 4 kHz written in {time.time() - t0:.1f} s", flush=True)
        os.chdir(root)
        try:
            _reset_counts()  # just before the main path
            t0 = time.time()
            (out,) = process.main(["dataset=circor", "pretrain=operaCT", "dim=768",
                                   "random_init=True", "source_sr=4000"])
            proc_s = time.time() - t0
            counts = _all_counts()
            feats = np.load(out)
            files = [os.path.join(root, str(f))  # sound_dir_loc holds relative paths
                     for f in np.load("feature/circor_eval/sound_dir_loc.npy")]
            t0 = time.time()
            ((*scores,),) = linear_eval.main(["task=circor_murmurs", "pretrain=operaCT",
                                              "dim=768", "n_run=5"])
            lp_s = time.time() - t0
        finally:
            os.chdir(cwd)
        batches = -(-n_clips // 16)
        _require(feats.shape == (n_clips, 768) and bool(np.isfinite(feats).all()),
                 f"cli.process features {feats.shape}")
        _require(counts["swin_attn"] == counts["swin_mlp"] == 12 * batches,
                 f"cli.process launches {counts} for {batches} batches")
        _require(counts["logmel"] == 0, f"logmel launched {counts['logmel']} times on the default path")
        scores = np.asarray(scores, np.float64)
        _require(len(scores) == 5 and bool(np.isfinite(scores).all()), f"test AUROCs {scores}")
        print(f"[main path] cli.process dataset=circor pretrain=operaCT dim=768 source_sr=4000: "
              f"{n_clips} clips in {proc_s:.1f} s = {n_clips / proc_s:.1f} clips/s (host decode, "
              f"trim and pad at 4 kHz, device upsample, mel, 12 + 12 swin launches a batch: "
              f"{counts['swin_attn']} + {counts['swin_mlp']}; logmel 0); cli.linear_eval "
              f"task=circor_murmurs n_run=5 in {lp_s:.1f} s: test AUROC "
              + " ".join(f"{s:.4f}" for s in scores)
              + f", mean {scores.mean():.4f} +- {scores.std():.4f}; {smi}", flush=True)

        # use_pallas_mel: the same files through the logmel kernel, both towers
        fused, fc, fb = _logmel_extract("operaCT", files, True, source_sr=4000)
        cos = _per_clip_cos(fused, feats)
        _require(cos.min() >= SAME_ROUNDING_BAR, f"operaCT use_pallas_mel cosine {cos.min()}")
        _require(fc["logmel"] == fb, f"operaCT logmel launches {fc['logmel']} for {fb} batches")
        gt_files = files[:48]
        g_def, g_dc, g_db = _logmel_extract("operaGT", gt_files, False, source_sr=4000)
        g_fused, g_fc, g_fb = _logmel_extract("operaGT", gt_files, True, source_sr=4000)
        g_cos = _per_clip_cos(g_fused, g_def)
        _require(g_dc["logmel"] == 0, f"operaGT default path launched logmel {g_dc['logmel']}")
        _require(g_fc["logmel"] == g_fb, f"operaGT logmel launches {g_fc['logmel']} for {g_fb}")
        _require(g_cos.min() >= SAME_ROUNDING_BAR, f"operaGT use_pallas_mel cosine {g_cos.min()}")
        print(f"[main path] use_pallas_mel, per-clip cosine to the default path: operaCT "
              f"{cos.min():.7f} min over {len(cos)} clips ({fc['logmel']} logmel launches, "
              f"{fb} batches); operaGT {g_cos.min():.7f} min over {len(gt_files)} files "
              f"({g_fc['logmel']} launches, {g_fb} batches; the default path 0); bar "
              f"{SAME_ROUNDING_BAR}", flush=True)

        # source_sr: the device upsample against scipy, the features against
        # the 16 kHz host path (f32 wire: the decode is exact)
        src = FeatureExtractor("operaCT", dim=768, input_sec=8, random_init=True, seed=SEED,
                               pad0=True, wire_format="f32", source_sr=4000, device="cuda")
        err = 0.0
        for f in files[:8]:
            x4, _ = load_wav(f, sr=4000)
            with torch.inference_mode():
                up, _ = src._prologue(torch.from_numpy(x4[None]).cuda(),
                                      torch.tensor([len(x4)], device="cuda"))
            err = max(err, float(np.abs(up[0].cpu().numpy() - resample_poly(x4, 4, 1)).max()))
        _require(err < RESAMPLE_ATOL, f"device upsample vs scipy max|d| {err}")
        sub = files[:64]
        f_src = src.extract_files(sub)
        host = FeatureExtractor("operaCT", dim=768, input_sec=8, random_init=True, seed=SEED,
                                pad0=True, wire_format="f32", device="cuda")
        s_cos = _per_clip_cos(f_src, host.extract_files(sub))
        # a clip under input_sec is zero-padded at the source rate, so the
        # FIR rings from its end into that padding inside the valid length
        short = np.array([len(pipelines._load_trim(f, 4000)) < 8 * 4000 for f in sub])
        lo_long, lo_short = s_cos[~short].min(), s_cos[short].min() if short.any() else 1.0
        _require(s_cos.min() >= SOURCE_SR_BAR, f"source_sr vs 16 kHz host path cosine {s_cos.min()}")
        print(f"[main path] source_sr=4000: the device upsample of 8 clips vs scipy max|d| "
              f"{err:.3g} (bar {RESAMPLE_ATOL}); features vs the 16 kHz host path (f32 wire), "
              f"per-clip cosine min {lo_long:.7f}, median {np.median(s_cos[~short]):.7f} over "
              f"{int((~short).sum())} clips of 8 s or more, min {lo_short:.7f} over "
              f"{int(short.sum())} shorter clips padded at 4 kHz (bar {SOURCE_SR_BAR}, the JAX "
              f"package's: the FIR rings past each clip's end, as in its prologue)", flush=True)
        del src, host
    return {"logmel": fc["logmel"] + g_fc["logmel"]}


def phase_logmel_throughput(smi: str):
    """Device-resident operaCT clips/s at B=64 with and without the logmel
    kernel, in turns, and where a use_pallas_mel batch's device time goes."""
    import torch

    from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor
    from heart_murmur_detection_tpu_torch.ops import mel

    B, n = 64, 10 * 16000
    g = torch.Generator(device="cpu").manual_seed(SEED + 20)
    wav = torch.zeros(B, (n + 511) // 512 * 512, dtype=torch.int16)
    wav[:, :n] = (torch.randn(B, n, generator=g) * 3000).to(torch.int16)
    wav, lengths = wav.cuda(), torch.full((B,), n, dtype=torch.int32, device="cuda")
    ms = {}
    for use in (False, True, True, False):  # in turns
        ex = FeatureExtractor("operaCT", dim=768, random_init=True, seed=SEED,
                              use_pallas_mel=use, device="cuda")
        fn = ex._build()
        ms.setdefault(use, []).append(_time_ms(lambda: fn(wav, lengths), iters=10, warm=2))
    ex = FeatureExtractor("operaCT", dim=768, random_init=True, seed=SEED, use_pallas_mel=True,
                          device="cuda")
    fn = ex._build()
    groups = _device_ms(lambda: fn(wav, lengths),
                        groups_by={"logmel": "logmel_kernel", "swin_attn": "swin_attn_kernel",
                                   "swin_mlp": "swin_mlp_kernel"})
    wall = min(ms[True])
    with torch.inference_mode():
        w = ex._prologue(wav, lengths)[0]
    ev = _time_ms(lambda: mel.fused_logmel(w))
    alone = _device_ms(lambda: mel.fused_logmel(w), groups_by={"logmel": "logmel_kernel"})
    print(f"[profile] logmel alone on this batch's waveform: {ev:.4f} ms a launch by CUDA events "
          f"(20 back to back), {alone['logmel']:.4f} ms by the profiler", flush=True)
    # the trace is trusted for the batch's idle share only where it reads
    # logmel as CUDA events do; else the event time stands in for it
    trusted = abs(groups["logmel"] - ev) <= 0.05 * ev
    if not trusted:
        groups["logmel"] = ev
    busy = sum(groups.values())
    print(f"[main path] {smi}: device-resident 10-s clips B={B}: default mel "
          f"{' / '.join(f'{v:.2f}' for v in ms[False])} ms/batch = "
          f"{B * 1000 / min(ms[False]):.1f} clips/s; use_pallas_mel "
          f"{' / '.join(f'{v:.2f}' for v in ms[True])} ms/batch = {B * 1000 / wall:.1f} clips/s "
          f"(in turns: default, fused, fused, default)", flush=True)
    print(f"[profile] one use_pallas_mel batch B={B}: {wall:.2f} ms unprofiled, device busy "
          f"{busy:.2f} ms ({100 * (1 - busy / wall):.1f}% idle"
          + ("" if trusted else "; logmel at its CUDA-event time, the trace read it "
             "short") + "): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in groups.items() if k != "other")
          + f", glue (wire decode, mel normalisation, patch embed, pads, pooling, LN) "
          f"{groups['other']:.2f} ms", flush=True)


# ---------------------------------------------------------------------------
# phase 20: the attention-half modes of the TPU kernels K10 / K11
# ---------------------------------------------------------------------------

ABLATE_MODES = ("norm_before", "fast", "bf16_exp", "no_softmax", "q_passthrough")


def _ablate_work(B, Np, C, heads, mode):
    """(bytes, operations) of one vit_attn launch (the attention core) in
    `mode` with every key real: q passthrough reads the q third and writes
    it to o_pre."""
    if mode == "q_passthrough":
        return 2 * 2 * B * Np * C, 0
    return _vit_work(B, Np, Np, C, heads)["vit_attn"]


def phase_attn_ablate(smi: str):
    """Phase 20: vit_attn's attention modes, the port of K10
    (bench/gt_attn_opt.py) and K11 (bench/vit_attn_ablate.py), at their
    shape (B=64 x 1040 x 384, 6 heads, all keys real, q unscaled): each mode
    against its plain version (o_pre cosine, and with vit_proj the branch
    cosine, two launches bitwise equal), aligned_hcat's ValueError; then
    the main path, every mode name of both files chained 8 halves deep
    (bench/attn_ablate.py), with its launches by mode; and each name's
    8-chain time against the production stable chain and SDPA (scale 1.0).
    Returns (measurements by mode for the kernels JSON: the attention core,
    8 launches, against 8 SDPA calls; launches by mode)."""
    import torch

    from heart_murmur_detection_tpu_torch.bench import attn_ablate as ab
    from heart_murmur_detection_tpu_torch.ops import vit

    B, Np, C, H = ab.B, ab.NP, ab.C, ab.HEADS
    x, rng = ab.inputs("cuda")
    p = ab.half_params(ab.draw_weights(rng, C), H, "cuda")
    qkv = vit.vit_qkv(x, p)
    q, k, v = qkv[0], qkv[1], qkv[2]
    sdpa_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=1.0))
    meas = {}
    for mode in ABLATE_MODES:
        o = vit.vit_attn(qkv, p, mode=mode)
        o_ref = vit.vit_attn_core_ref(qkv, p, mode=mode)
        got = vit.vit_proj(o, x, p)
        want = vit.vit_attn_out_ref(x, qkv, p, mode=mode)
        torch.cuda.synchronize()
        co = _cos(o.float().cpu(), o_ref.float().cpu())
        c = _branch(got, want, x)
        same = (torch.equal(o, vit.vit_attn(qkv, p, mode=mode))
                and torch.equal(got, vit.vit_proj(o, x, p)))
        err = float((o.float() - o_ref.float()).abs().max())
        k_ms = _time_ms(lambda: vit.vit_attn(qkv, p, mode=mode))
        pair_ms = _time_ms(lambda: vit.vit_proj(vit.vit_attn(qkv, p, mode=mode), x, p))
        p_ms = _time_ms(lambda: vit.vit_attn_core_ref(qkv, p, mode=mode), iters=3, warm=1)
        work = Work()
        work.add(*_ablate_work(B, Np, C, H, mode), n=ab.DEPTH)
        lib = ab.DEPTH * sdpa_ms if mode in ab.SOFTMAX_MODES else None
        meas[mode] = {"ms": ab.DEPTH * k_ms, "plain_ms": ab.DEPTH * p_ms, "err": err,
                      "work": work, "library_ms": lib}
        print(f"[attn modes] vit_attn {mode} B={B} Np={Np} C={C}: o_pre cos {co:.7f} max|d| "
              f"{err:.4g}, with vit_proj branch cos {c:.7f}; bitwise repeatable {same}; kernel "
              f"{k_ms:.4f} ms plain {p_ms:.4f} ms a launch, with vit_proj {pair_ms:.4f} ms "
              f"({ab.DEPTH * pair_ms:.3f} ms for {ab.DEPTH}); bound "
              f"{work.bound_ms / ab.DEPTH:.4f} ms ({work.bound_by}); SDPA "
              + (f"{sdpa_ms:.4f} ms" if lib is not None else "n/a (no softmax)"), flush=True)
        _require(min(co, c) >= KERNEL_BAR and same,
                 f"vit_attn {mode}: o_pre cosine {co}, branch cosine {c}, repeatable {same}")
    try:
        vit.vit_attn(qkv, p, mode="aligned_hcat")
        _require(False, "aligned_hcat launched at C=384, 6 heads")
    except ValueError as e:
        print(f"[attn modes] aligned_hcat raises ValueError: {e}", flush=True)

    # the main path: every mode name of both files, 8 halves deep
    _reset_counts()  # just before the main path
    names = 0
    for file, modes in ab.FILES.items():
        xf, rf = ab.inputs("cuda")
        for name in modes:
            pf = ab.half_params(ab.draw_weights(rf, C), H, "cuda")
            try:
                out = ab.chain(xf, pf, ab.JAX_MODES[(file, name)])
            except ValueError:
                _require(name == "aligned_hcat", f"{file} {name} raised")
                continue
            _require(bool(torch.isfinite(out.float()).all()), f"{file} {name} chain not finite")
            names += 1
    torch.cuda.synchronize()
    counts, by_mode = _all_counts(), vit.mode_launch_counts()
    want = {m: ab.DEPTH * sum(ab.JAX_MODES[(f, n)] == m for f, ns in ab.FILES.items() for n in ns)
            for m in ABLATE_MODES}
    print(f"[attn modes] the 8-deep chains of {names} mode names: vit_qkv {counts['vit_qkv']}, "
          f"vit_proj {counts['vit_proj']}, vit_attn by mode {by_mode} (want {want})", flush=True)
    _require(counts["vit_qkv"] == counts["vit_attn"] == counts["vit_proj"] == ab.DEPTH * names
             and all(by_mode[m] == want[m] for m in ABLATE_MODES), f"chain launches {by_mode}")
    for file, modes in ab.FILES.items():
        xf, rf = ab.inputs("cuda")
        for name in modes:
            row = ab.measure(file, name, xf, ab.draw_weights(rf, C))
            print(f"[attn modes] {json.dumps(row)} {smi}", flush=True)
            if "result" not in row:
                _require(row["branch_cos"] >= KERNEL_BAR and row["bitwise_repeat"],
                         f"{file} {name}: {row}")
    return meas, {m: by_mode[m] for m in ABLATE_MODES}


# ---------------------------------------------------------------------------
# phase 21: fine-tuning
# ---------------------------------------------------------------------------

FT_EPOCHS = 3  # epochs of each cli.finetune seed (the protocol's 64 cut for time)
FT_SEEDS = 3  # operaCT's cli.finetune seeds (the protocol's 5 cut for time)
# (pretrain, encoder kind, batch): the step-0 rule runs at the timed batch
FT_TOWERS = (("operaCT", "htsat", 64), ("operaGT", "gt", 64), ("audiomae", "audiomae", 32))


def _ft_per_step(kind: str, B: int) -> dict:
    """Kernel launches of one fine-tuning step: the train blocks' forward
    and backward kernels (htsat: the 10 blocks of stages 0-2, stage 3 plain
    float32; the ViTs: 12 blocks) and the ordered reductions."""
    from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig
    from heart_murmur_detection_tpu_torch.models.vit_mae import (audiomae_base_config,
                                                                 mae_vit_small_config)

    if kind == "htsat":
        cfg = HTSATConfig()
        d = sum(cfg.depths[:3])
        return {"swin_attn": d, "swin_mlp": d, "swin_attn_bwd": d, "swin_mlp_bwd": d,
                "swin_wgrad": 4 * d, "swin_reduce": _reduce_per_step(cfg) // 2}
    cfg = mae_vit_small_config() if kind == "gt" else audiomae_base_config()
    d = cfg.depth
    return {"vit_qkv": d, "vit_attn": d, "vit_proj": d, "vit_mlp": d, "vit_attn_bwd": d,
            "vit_mlp_bwd": d, "swin_wgrad": 4 * d, "swin_reduce": 2 * d}


def _ft_eval_per_batch(kind: str) -> dict:
    """Kernel launches of one eval (predict) batch."""
    if kind == "htsat":
        return {"swin_attn": 12, "swin_mlp": 12}
    return {"vit_qkv": 12, "vit_attn": 12, "vit_proj": 12, "vit_mlp": 12}


def _ft_cli(pretrain: str, n_run: int):
    """cli.finetune on the card in bf16 (the working directory holds the
    processed task); returns (test AUROCs, launches of the run, seconds)."""
    from heart_murmur_detection_tpu_torch.cli import finetune as cli_finetune

    _reset_counts()  # just before the main path
    t0 = time.time()
    ((*scores,),) = cli_finetune.main([
        "task=circor_murmurs", f"pretrain={pretrain}", "compute_dtype=bfloat16",
        "random_init=True", f"n_run={n_run}", f"epochs={FT_EPOCHS}", "device=cuda"])
    return scores, _all_counts(), time.time() - t0


def _ft_steps(model, xb, yb, valid, cw, mm, impl, steps):
    """`steps` fine-tuning steps of a copy of model on one batch: (losses,
    the step-0 gradients by name)."""
    import copy

    import torch

    from heart_murmur_detection_tpu_torch.train import finetune as ft
    from heart_murmur_detection_tpu_torch.train.linear_eval import ClippedAdam

    m = copy.deepcopy(model)
    names = [n for n, _ in m.named_parameters()]
    opt = ClippedAdam(m.parameters(), 3, 1e-4, 0.99, 1.0)
    gen = torch.Generator(device=xb.device).manual_seed(SEED + 21)
    losses, g0 = [], None
    for s in range(steps):
        loss, grads = ft.train_step(m, opt, xb, yb, valid, cw, gen, mm, impl, 1e-4)
        if s == 0:
            g0 = {n: g.float() for n, g in zip(names, grads)}
        losses.append(float(loss))
    return losses, g0


def _poison(fill: str):
    """Fill the card memory the caching allocator will hand out next (a
    block of 90% of the free memory and 256 small-pool blocks, freed again)
    with NaN or a normal draw, so that a kernel reading memory it never
    wrote reads other values than in the run before."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    blocks = [torch.empty(int(free * 0.9) // 4, device="cuda")]
    blocks += [torch.empty(1 << 17, device="cuda") for _ in range(256)]
    for b in blocks:
        b.fill_(float("nan")) if fill == "nan" else b.normal_()
    torch.cuda.synchronize()
    del blocks


def _ft_repeat(tag, model, x, y, valid, cw, ref):
    """Repeatability of 3 kernel-path steps against the run `ref` (losses,
    step-0 gradients): again as it was; after the allocator's free memory
    was filled with NaN, then with a normal draw; and under
    torch.use_deterministic_algorithms(True) (warn_only: the ops it warns of
    are printed). Prints, for each, whether the losses and every step-0
    gradient leaf are bitwise equal to ref and which leaves differ; fails
    unless all are."""
    import warnings

    import torch

    def run():
        return _ft_steps(model, x, y, valid, cw, torch.bfloat16, "kernel", 3)

    out = {}
    out["again"] = run()
    _poison("nan")
    out["after NaN fill"] = run()
    _poison("normal")
    out["after normal fill"] = run()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            out["deterministic algorithms"] = run()
        finally:
            torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split("\n")[0][:160] for w in caught
                  if "deterministic" in str(w.message)})
    rows = {}
    for name, (losses, g0) in out.items():
        diff = {q: float(((g0[q] - ref[1][q]).abs().max() / ref[1][q].abs().max().clamp(min=1e-30)))
                for q in g0 if not torch.equal(g0[q], ref[1][q])}
        worst = sorted(diff, key=diff.get, reverse=True)[:5]
        rows[name] = {"losses_bitwise": losses == ref[0], "losses": losses,
                      "leaves_differing": len(diff), "of": len(g0),
                      "worst": {q: f"{diff[q]:.3g}" for q in worst},
                      "finite": all(bool(torch.isfinite(g).all()) for g in g0.values())}
    print(f"[finetune] {tag} repeatability of 3 kernel-path steps (ref losses {ref[0]}): "
          f"{json.dumps(rows)}; ops without a deterministic version: {ops}", flush=True)
    _require(all(r["losses_bitwise"] and not r["leaves_differing"] and r["finite"]
                 for r in rows.values()), f"{tag}: 3 kernel-path steps do not repeat bitwise")


def phase_finetune(smi: str, dev):
    """Phase 21: fine-tuning on the card. A synthetic CirCor corpus through
    cli.process, then cli.finetune pretrain=operaCT compute_dtype=bfloat16
    (FT_SEEDS seeds, FT_EPOCHS epochs each: finite test AUROCs) and one seed
    of operaGT and of Audio-MAE, each with its kernel launches checked
    against the count its steps and predict batches imply, and operaCT's
    seed 0 run again to the same test AUROC; then, per tower at full width
    on one cached batch of the tower's batch size: the step time on the
    kernels against the plain bf16 path (impl="plain"), the launches of one
    step, 3 steps of each path from the same weights with the step-0
    gradient rule against strict f32 (TF32 off), and the kernel path's 3
    steps repeated bitwise (_ft_repeat). Returns the operaCT run's
    launches."""
    import numpy as np
    import torch

    from heart_murmur_detection_tpu_torch.bench.process_time import write_circor
    from heart_murmur_detection_tpu_torch.cli import process
    from heart_murmur_detection_tpu_torch.train import finetune as ft
    from heart_murmur_detection_tpu_torch.train.linear_eval import ClippedAdam
    from heart_murmur_detection_tpu_torch.utils.precision import strict_f32

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        n_clips = write_circor(root, REPEAT_PATIENTS, seed=SEED + 21)
        os.chdir(root)
        try:
            process.main(["dataset=circor", "pretrain=operaCT", "dim=768", "random_init=True",
                          "source_sr=4000"])
            split = np.load("feature/circor_eval/train_test_split.npy")
            n_tr, n_va, n_te = (int((split == s).sum()) for s in ("train", "val", "test"))
            runs = {}
            for pretrain, kind, B in FT_TOWERS:
                n_run = FT_SEEDS if pretrain == "operaCT" else 1
                scores, counts, sec = _ft_cli(pretrain, n_run)
                scores = np.asarray(scores, np.float64)
                steps = n_run * FT_EPOCHS * (-(-n_tr // B))
                batches = n_run * (FT_EPOCHS * -(-n_va // 64) + -(-n_te // 64))
                per, ev = _ft_per_step(kind, B), _ft_eval_per_batch(kind)
                want = {q: per.get(q, 0) * steps + ev.get(q, 0) * batches for q in {*per, *ev}}
                print(f"[finetune] cli.finetune pretrain={pretrain} compute_dtype=bfloat16 "
                      f"n_run={n_run} epochs={FT_EPOCHS} B={B} on {n_clips} clips ({n_tr} train, "
                      f"{n_va} val, {n_te} test) in {sec:.1f} s: test AUROC "
                      + " ".join(f"{a:.4f}" for a in scores)
                      + f", mean {scores.mean():.4f} +- {scores.std():.4f}; launches "
                      f"{ {q: counts[q] for q in sorted(want)} } ({steps} steps x {per} + "
                      f"{batches} predict batches x {ev}); {smi}", flush=True)
                _require(len(scores) == n_run and bool(np.isfinite(scores).all()),
                         f"{pretrain} test AUROCs {scores}")
                _require(all(counts[q] == v for q, v in want.items()),
                         f"{pretrain} launches {counts}, want {want}")
                runs[pretrain] = counts
                if pretrain == "operaCT":  # seed 0 once more in this process
                    (again,), _, _ = _ft_cli(pretrain, 1)
                    print(f"[finetune] cli.finetune pretrain=operaCT seed 0 again: test AUROC "
                          f"{again!r} vs {float(scores[0])!r}, equal {again == scores[0]}",
                          flush=True)
                    _require(again == scores[0], "cli.finetune seed 0 does not repeat")
            x_pad8 = np.load("feature/circor_eval/spectrogram_pad8.npy")
            x_fbank = np.load("feature/circor_eval/fbank_audiomae.npy")
            y_all = np.load("feature/circor_eval/murmurs.npy").astype(np.int64)
        finally:
            os.chdir(cwd)

    for pretrain, kind, B in FT_TOWERS:
        xs = x_fbank if kind == "audiomae" else x_pad8
        model = ft.EncoderClassifier(kind, 3, "linear", 384 if kind == "gt" else 768,
                                     generator=torch.Generator().manual_seed(SEED)).to(dev)
        xb = torch.from_numpy(xs[:B].astype(np.float32)).to(dev)
        yb = torch.from_numpy(y_all[:B]).to(dev)
        valid = torch.ones(B, device=dev)
        cw = torch.ones(3, device=dev)
        opt_of = lambda m: ClippedAdam(m.parameters(), 3, 1e-4, 0.99, 1.0)
        with strict_f32():
            times = {}
            for impl in ("kernel", "plain"):
                import copy

                m = copy.deepcopy(model)
                opt = opt_of(m)
                gen = torch.Generator(device=dev).manual_seed(SEED + 22)
                step = lambda: ft.train_step(m, opt, xb, yb, valid, cw, gen, torch.bfloat16, impl,
                                             1e-4)
                step()
                torch.cuda.synchronize()
                if impl == "kernel":
                    _reset_counts()
                    step()
                    torch.cuda.synchronize()
                    one = _all_counts()
                times[impl] = _time_ms(step, iters=3, warm=1)
                del m, opt
            per = _ft_per_step(kind, B)
            print(f"[finetune] {pretrain} step B={B} full width, bf16: kernels {times['kernel']:.2f} "
                  f"ms, plain bf16 path {times['plain']:.2f} ms "
                  f"({times['plain'] / times['kernel']:.2f}x); one step's launches "
                  f"{ {q: one[q] for q in per} } (want {per}); {smi}", flush=True)
            _require(all(one[q] == v for q, v in per.items()), f"{pretrain} step launches {one}")
            torch.cuda.reset_peak_memory_stats()
            lk, gk = _ft_steps(model, xb, yb, valid, cw, torch.bfloat16, "kernel", 3)
            lp, gp = _ft_steps(model, xb, yb, valid, cw, torch.bfloat16, "plain", 3)
            lf, gf = _ft_steps(model, xb, yb, valid, cw, torch.float32, "autograd", 1)
            peak = torch.cuda.max_memory_allocated() / 2**30
            _step0_rule(f"[finetune] {pretrain} 3 steps at B={B} (peak {peak:.1f} GiB allocated)",
                        lk, lp, lf, gk, gp, gf)
            del gp, gf
            _ft_repeat(pretrain, model, xb, yb, valid, cw, (lk, gk))
        del model
        torch.cuda.empty_cache()
    return runs["operaCT"]


# ---------------------------------------------------------------------------
# phases 22-23: HeAR (ViT-L/16 over mel-PCEN), the TPU kernels K6 / K7 at C 1024
# ---------------------------------------------------------------------------

# (C, heads, Np, n_real): one clip's 96 patches and cls, padded to 112
HEAR_GEOM = (1024, 16, 112, 97)
HEAR_DEPTH = 24
HEAR_F32_BAR = 0.9999  # HeAR's own class: bench/numerics_pin.py holds the JAX fused HeAR to it
# Through 24 ViT-L blocks at random weights the plain bf16 flow reproduces
# itself only to 0.99994 when nothing but its products' sum order changes
# (a batch of 16 against a clip at a time), and the kernel path reads the
# same against it (PERF.md §6): the kernel path is held to this fixed
# bar, twice that distance, with the plain flow's spread printed beside it
HEAR_PLAIN_BAR = 0.99988


def _ptxas_of(log: str, marker: str) -> list:
    """The ptxas register and spill lines of each kernel whose mangled name
    holds `marker` (a template argument such as ILi1024E)."""
    lines, out = log.splitlines(), []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and marker in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            usage = [x.strip() for x in lines[i + 1:i + 5] if "registers" in x or "spill" in x]
            out.append(f"{name}: {' ; '.join(usage)}")
    return out


def phase_hear_kernels(dev, build_log: str, smi: str):
    """Phase 22: the four ViT kernels at HeAR's geometry (C 1024, 16 heads
    of 64, hidden 4096, 112 tokens with 97 real). The vit_attn core at B=16
    and B=1, both softmax modes: o_pre and, through vit_proj, the attention
    half's branch (out - x) at cosine >= KERNEL_BAR against the plain
    versions, two launches bitwise equal; CUDA-event ms, bound, plain ms and
    SDPA on the same q, k, v. Then, at B = 1, 16 and 64,
    bench/mlp_layouts.py's comparison: vit_qkv (and its LN1 output),
    vit_proj and vit_mlp (the branch) at cosine >= KERNEL_BAR, two launches
    bitwise equal, each timed (a CUDA graph of 20 launches replayed,
    medians over 5 turns) in turns with its library calls (torch.addmm on
    the LN output; addmm + the residual; the MLP's layer_norm, addmm, gelu,
    addmm, add chain). The ptxas lines of the C = 1024 kernels. Returns
    {name@hear: measurement} summed over one B=16 forward's 24 launches of
    each kernel in the extraction's fast softmax mode."""
    import torch

    from heart_murmur_detection_tpu_torch.bench import mlp_layouts
    from heart_murmur_detection_tpu_torch.ops import vit

    for ln in _ptxas_of(build_log, "ILi1024E") + _ptxas_of(build_log, "vit_rows_gemm"):
        print(f"[hear kernel] ptxas {ln}", flush=True)
    C, heads, Np, n_real = HEAR_GEOM
    p = _vit_params(C, heads, dev, SEED + 22)
    tot = {}
    for B in (B_KERNEL, 1):
        g = torch.Generator(device="cpu").manual_seed(SEED + 22 + B)
        x = (torch.randn(B, Np, C, generator=g) * 0.5).to(dev, torch.bfloat16)
        x[:, n_real:] = 0.0  # the padded rows of a first block
        w_attn = _vit_work(B, Np, n_real, C, heads)["vit_attn"]
        bound = Work()
        bound.add(*w_attn)
        ref = vit.vit_qkv_ref(x, p)
        q, kk, vv = ref[0], ref[1][:, :, :n_real], ref[2][:, :, :n_real]
        sdpa_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kk, vv, scale=1.0))
        for mode in ("stable", "fast"):
            o = vit.vit_attn(ref, p, n_real, mode)
            o_ref = vit.vit_attn_core_ref(ref, p, n_real, mode)
            got, want = vit.vit_proj(o, x, p), vit.vit_attn_out_ref(x, ref, p, n_real, mode)
            torch.cuda.synchronize()
            co, cb = _cos(o.float().cpu(), o_ref.float().cpu()), _branch(got, want, x)
            same = (torch.equal(o, vit.vit_attn(ref, p, n_real, mode))
                    and torch.equal(got, vit.vit_proj(o, x, p)))
            err = float((o.float() - o_ref.float()).abs().max())
            k_ms = _time_ms(lambda: vit.vit_attn(ref, p, n_real, mode))
            p_ms = _time_ms(lambda: vit.vit_attn_core_ref(ref, p, n_real, mode), iters=5, warm=1)
            print(f"[hear kernel] vit_attn C={C} Np={Np} n_real={n_real} B={B} {mode} softmax: "
                  f"o_pre cos {co:.7f} max|d| {err:.4g}, with vit_proj branch cos {cb:.7f}; "
                  f"bitwise repeatable {same}; kernel {k_ms:.4f} ms plain {p_ms:.4f} ms bound "
                  f"{bound.bound_ms:.4f} ms ({bound.bound_by}); "
                  f"scaled_dot_product_attention (keys sliced to n_real) {sdpa_ms:.4f} ms",
                  flush=True)
            _require(min(co, cb) >= KERNEL_BAR and same,
                     f"vit_attn HeAR B={B} {mode}: o_pre cosine {co}, branch {cb}, repeatable {same}")
            if mode == "fast" and B == B_KERNEL:  # the extraction's mode and batch
                w = Work()
                w.add(*w_attn, n=HEAR_DEPTH)
                tot["vit_attn@hear"] = {"ms": HEAR_DEPTH * k_ms, "plain_ms": HEAR_DEPTH * p_ms,
                                        "err": err, "work": w, "library_ms": HEAR_DEPTH * sdpa_ms}
    # vit_qkv, vit_proj and vit_mlp against their library calls, in turns
    halves = (("vit_qkv", "rows", "addmm"), ("vit_proj", "kernel", "addmm"),
              ("vit_mlp", "rows", "chain"))
    for B in (1, B_KERNEL, 64):
        r = mlp_layouts.compare(B, p, seed=SEED + 22)
        for ln in mlp_layouts.report("[hear layouts]", B, r, smi):
            print(ln, flush=True)
        for half, key, _ in halves:
            c = min(r[half]["cos"][key], r[half]["cos"].get("ln1", 1.0))
            same = r[half]["same"][key]
            _require(c >= KERNEL_BAR and same,
                     f"{half} HeAR B={B} ({key}): cosine {c}, repeatable {same}")
        if B != B_KERNEL:
            continue
        work = _vit_work(B, Np, n_real, C, heads)
        for half, key, lib in halves:
            w = Work()
            w.add(*work[half], n=HEAR_DEPTH)
            ms = r[half]["ms"]
            # the MLP's chain is five calls: no one library call computes it
            tot[f"{half}@hear"] = {"ms": HEAR_DEPTH * ms[key],
                                   "plain_ms": HEAR_DEPTH * r[half]["plain_ms"],
                                   "err": r[half]["max_abs_err"][key], "work": w,
                                   "library_ms": None if half == "vit_mlp" else HEAR_DEPTH * ms[lib]}
        print(f"[hear layouts] one B={B} forward's 24 launches (CUDA-graph replay, medians over "
              f"turns): " + "; ".join(
                  f"{half} {HEAR_DEPTH * r[half]['ms'][key]:.3f} ms ({lib} "
                  f"{HEAR_DEPTH * r[half]['ms'][lib]:.3f})" for half, key, lib in halves)
              + f"; {smi}", flush=True)
    return tot


def phase_hear(smi: str):
    """Phase 23: the HeAR extraction path end to end on the card. A
    synthetic CirCor corpus (4 kHz WAVs) through cli.process pretrain=hear
    (host load at 16 kHz, 2-s clips, mel-PCEN on the card, the 24 ViT-L
    blocks on the kernels) and cli.linear_eval pretrain=hear (5 seeds): five
    finite test AUROCs, 24 launches of each ViT kernel a batch; 20 clips'
    features against the plain bf16 flow and the strict f32 path (TF32
    off); device-resident clips/s at B=64, kernel path and plain bf16 path
    in turns; a profile of one batch from a fresh child process. Returns
    the launches of the cli.process run."""
    import numpy as np
    import torch

    from heart_murmur_detection_tpu_torch.bench import hear_rate
    from heart_murmur_detection_tpu_torch.bench.process_time import write_circor
    from heart_murmur_detection_tpu_torch.cli import linear_eval, process
    from heart_murmur_detection_tpu_torch.extract.registry import initialize_pretrained_model
    from heart_murmur_detection_tpu_torch.models.hear import extract_hear_feature

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        n_clips = write_circor(root, REPEAT_PATIENTS, seed=SEED + 23)
        os.chdir(root)
        try:
            _reset_counts()  # just before the HeAR path
            t0 = time.time()
            (out,) = process.main(["dataset=circor", "pretrain=hear", "random_init=True"])
            proc_s = time.time() - t0
            counts = _all_counts()
            feats = np.load(out)
            files = [os.path.join(root, str(f))
                     for f in np.load("feature/circor_eval/sound_dir_loc.npy")]
            t0 = time.time()
            ((*scores,),) = linear_eval.main(["task=circor_murmurs", "pretrain=hear", "n_run=5"])
            lp_s = time.time() - t0
        finally:
            os.chdir(cwd)
        batches = -(-n_clips // 16)
        _require(out.endswith("hear_feature.npy") and feats.shape == (n_clips, 512)
                 and bool(np.isfinite(feats).all()), f"cli.process hear features {feats.shape}")
        want = HEAR_DEPTH * batches
        _require(all(counts[k] == want for k in ("vit_qkv", "vit_attn", "vit_proj", "vit_mlp")),
                 f"cli.process hear launches {counts} for {batches} batches")
        scores = np.asarray(scores, np.float64)
        _require(len(scores) == 5 and bool(np.isfinite(scores).all()), f"test AUROCs {scores}")
        print(f"[hear] cli.process dataset=circor pretrain=hear random_init=True: {n_clips} clips "
              f"in {proc_s:.1f} s = {n_clips / proc_s:.1f} clips/s (host load at 16 kHz, 2-s "
              f"clips, mel-PCEN and 24 ViT-L blocks a batch on the card: launches "
              f"{ {k: counts[k] for k in ('vit_qkv', 'vit_attn', 'vit_proj', 'vit_mlp')} }, "
              f"{batches} batches); cli.linear_eval task=circor_murmurs pretrain=hear n_run=5 in "
              f"{lp_s:.1f} s: test AUROC " + " ".join(f"{a:.4f}" for a in scores)
              + f", mean {scores.mean():.4f} +- {scores.std():.4f}; {smi}", flush=True)

        # 20 clips against the plain bf16 flow and the strict f32 path, on
        # the same weights (the registry's random init, seed 0)
        model = initialize_pretrained_model("hear", random_init=True, seed=0).cuda()
        sub = files[:20]
        kern = extract_hear_feature(sub, model=model, device="cuda")
        plain = extract_hear_feature(sub, model=model, device="cuda", impl="plain")
        plain1 = extract_hear_feature(sub, model=model, device="cuda", impl="plain", batch_size=1)
        f32 = extract_hear_feature(sub, model=model, device="cuda", compute_dtype=torch.float32)
        c_cli = _per_clip_cos(kern[:16], feats[:16]).min()
        c_plain, c_f32 = _per_clip_cos(kern, plain).min(), _per_clip_cos(kern, f32).min()
        c_pf, c_pp = _per_clip_cos(plain, f32).min(), _per_clip_cos(plain, plain1).min()
        print(f"[hear] numerics, per-clip cosine min over {len(sub)} clips: kernel path vs plain "
              f"bf16 flow {c_plain:.7f} (bar {HEAR_PLAIN_BAR}; the plain flow's own sum-order "
              f"spread, plain at B=16 vs a clip at a time, {c_pp:.7f}); vs strict f32, TF32 off "
              f"{c_f32:.7f} (bar {HEAR_F32_BAR}; plain bf16 vs strict f32 {c_pf:.7f}); the first "
              f"batch again vs cli.process's {c_cli:.7f}", flush=True)
        _require(c_plain >= HEAR_PLAIN_BAR,
                 f"HeAR vs plain bf16 flow cosine {c_plain}, the flow's own spread {c_pp}")
        _require(c_f32 >= HEAR_F32_BAR and 1 - c_f32 <= F32_RATIO_LEAF * (1 - c_pf),
                 f"HeAR vs strict f32 cosine {c_f32} (plain bf16 {c_pf})")
        _require(c_cli >= SAME_ROUNDING_BAR, f"HeAR features vs cli.process {c_cli}")
        del model
        torch.cuda.empty_cache()

    _, kern_fn, plain_fn = hear_rate.setup()
    with torch.no_grad():
        r = hear_rate.rates(kern_fn, plain_fn)
    del kern_fn, plain_fn
    torch.cuda.empty_cache()
    C, heads, Np, n_real = HEAR_GEOM
    bound = Work()
    for w in _vit_work(hear_rate.B, Np, n_real, C, heads).values():
        bound.add(*w, n=HEAR_DEPTH)
    print(f"[hear throughput] {smi}: device-resident 2-s clips B={hear_rate.B}, in turns "
          f"(kernel, plain, plain, kernel): kernel path {r['kernel_ms']} ms/batch = "
          f"{r['kernel_clips_per_s']} clips/s; plain bf16 path {r['plain_ms']} ms/batch = "
          f"{r['plain_clips_per_s']} clips/s; the 96 block launches' bound {bound.bound_ms:.3f} "
          f"ms ({bound.bound_by})", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 24: the CLAP towers (2023: HTS-AT at 44.1 kHz on the TPU kernels K1-K3)
# ---------------------------------------------------------------------------

CLAP_PATIENTS = 60  # the host's 44.1 kHz load and resample is this phase's cost
CLAP_2022_BAR = 0.99999  # the Cnn14 tower on the card (strict f32) vs the CPU graph


def phase_clap(smi: str):
    """Phase 24: the CLAP towers end to end on the card. A synthetic CirCor
    corpus (4 kHz WAVs) through cli.process pretrain=clap2023 and
    pretrain=clap (host load at 44.1 kHz, 7-s / 5-s clips; the 2023 tower's
    12 swin blocks a batch on the kernels, as many launches a batch as an
    operaCT forward; the Cnn14 none) and cli.linear_eval pretrain=clap2023
    (5 seeds): five finite test AUROCs; 20 clips' 2023 features against the
    plain bf16 flow and the strict f32 path (TF32 off); the 2022 tower on
    the card against the CPU's float32 graph; device-resident clips/s at
    B=16, kernel path and plain bf16 path in turns; a profile of one batch
    from a fresh child process. Returns the launches of the 2023 run."""
    import numpy as np
    import torch

    from heart_murmur_detection_tpu_torch.bench import clap_rate
    from heart_murmur_detection_tpu_torch.bench.process_time import write_circor
    from heart_murmur_detection_tpu_torch.cli import linear_eval, process
    from heart_murmur_detection_tpu_torch.extract.registry import initialize_pretrained_model
    from heart_murmur_detection_tpu_torch.models.clap import extract_clap_feature

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        n_clips = write_circor(root, CLAP_PATIENTS, seed=SEED + 24)
        os.chdir(root)
        try:
            _reset_counts()  # just before the CLAP-2023 path
            t0 = time.time()
            (out23,) = process.main(["dataset=circor", "pretrain=clap2023", "random_init=True"])
            s23 = time.time() - t0
            counts = _all_counts()
            t0 = time.time()
            (out22,) = process.main(["dataset=circor", "pretrain=clap", "random_init=True"])
            s22 = time.time() - t0
            counts22 = {k: v - counts[k] for k, v in _all_counts().items()}
            f23, f22 = np.load(out23), np.load(out22)
            files = [os.path.join(root, str(f))
                     for f in np.load("feature/circor_eval/sound_dir_loc.npy")]
            t0 = time.time()
            ((*scores,),) = linear_eval.main(["task=circor_murmurs", "pretrain=clap2023",
                                              "n_run=5"])
            lp_s = time.time() - t0
        finally:
            os.chdir(cwd)
        batches = -(-n_clips // 16)
        for out, f, name in ((out23, f23, "clap2023"), (out22, f22, "clap")):
            _require(out.endswith(f"{name}_feature.npy") and f.shape == (n_clips, 1024)
                     and bool(np.isfinite(f).all()), f"cli.process {name} features {f.shape}")
        # one operaCT forward at the same batch: the launches a CLAP-2023 batch must match
        cola = initialize_pretrained_model("operaCT", random_init=True, seed=SEED).cuda()
        mel = torch.rand(16, 1001, 64, device="cuda")
        _reset_counts()
        cola.htsat(mel, None, torch.bfloat16, True)
        ct = _all_counts()
        del cola
        _require(ct["swin_attn"] == ct["swin_mlp"] > 0
                 and all(counts[k] == ct[k] * batches for k in ("swin_attn", "swin_mlp"))
                 and sum(counts.values()) == counts["swin_attn"] + counts["swin_mlp"],
                 f"cli.process clap2023 launches {counts} for {batches} batches (an operaCT "
                 f"forward: {ct})")
        _require(not any(counts22.values()), f"the Cnn14 tower launched {counts22}")
        scores = np.asarray(scores, np.float64)
        _require(len(scores) == 5 and bool(np.isfinite(scores).all()), f"test AUROCs {scores}")
        print(f"[clap] cli.process dataset=circor pretrain=clap2023 random_init=True: {n_clips} "
              f"clips in {s23:.1f} s = {n_clips / s23:.1f} clips/s (host load at 44.1 kHz, 7-s "
              f"clips, the frontend and 12 swin blocks a batch on the card: launches "
              f"{ {k: counts[k] for k in ('swin_attn', 'swin_mlp')} }, {batches} batches, "
              f"{ct['swin_attn']} + {ct['swin_mlp']} a batch as an operaCT forward); "
              f"pretrain=clap (Cnn14, 5-s clips, strict f32, no repo kernel) in {s22:.1f} s = "
              f"{n_clips / s22:.1f} clips/s; cli.linear_eval task=circor_murmurs "
              f"pretrain=clap2023 n_run=5 in {lp_s:.1f} s: test AUROC "
              + " ".join(f"{a:.4f}" for a in scores)
              + f", mean {scores.mean():.4f} +- {scores.std():.4f}; {smi}", flush=True)

        # 20 clips of the 2023 tower against the plain bf16 flow and the
        # strict f32 path, on the same weights (the registry's seed 0)
        model = initialize_pretrained_model("clap2023", random_init=True, seed=0).cuda()
        sub = files[:20]
        kern = extract_clap_feature(sub, "2023", model=model, device="cuda")
        plain = extract_clap_feature(sub, "2023", model=model, device="cuda", impl="plain")
        f32 = extract_clap_feature(sub, "2023", model=model, device="cuda",
                                   compute_dtype=torch.float32)
        c_cli = _per_clip_cos(kern[:16], f23[:16]).min()
        c_plain, c_f32 = _per_clip_cos(kern, plain).min(), _per_clip_cos(kern, f32).min()
        c_pf = _per_clip_cos(plain, f32).min()
        print(f"[clap] CLAP-2023 numerics, per-clip cosine min over {len(sub)} clips: kernel "
              f"path vs plain bf16 flow {c_plain:.7f} (bar {SAME_ROUNDING_BAR}); vs strict f32, "
              f"TF32 off {c_f32:.7f} (bar {F32_BAR}; plain bf16 vs strict f32 {c_pf:.7f}); the "
              f"first batch again vs cli.process's {c_cli:.7f}", flush=True)
        _require(c_plain >= SAME_ROUNDING_BAR, f"CLAP-2023 vs plain bf16 flow cosine {c_plain}")
        _require(c_f32 >= F32_BAR, f"CLAP-2023 vs strict f32 cosine {c_f32}")
        _require(c_cli >= SAME_ROUNDING_BAR, f"CLAP-2023 features vs cli.process {c_cli}")
        del model

        # the 2022 tower: the card's strict float32 against the CPU's graph
        m22 = initialize_pretrained_model("clap", random_init=True, seed=0)
        sub = files[:4]
        threads = torch.get_num_threads()
        torch.set_num_threads(os.cpu_count() or 1)
        t0 = time.time()
        cpu = extract_clap_feature(sub, "2022", model=m22, batch_size=4, device="cpu")
        cpu_s = time.time() - t0
        torch.set_num_threads(threads)
        card = extract_clap_feature(sub, "2022", model=m22.cuda(), batch_size=4, device="cuda")
        c22 = _per_clip_cos(card, cpu).min()
        c22_cli = _per_clip_cos(card, f22[:4]).min()
        print(f"[clap] CLAP-2022 (Cnn14) on the card under strict f32 vs the CPU's float32 "
              f"graph, per-clip cosine min over {len(sub)} clips: {c22:.8f} (bar "
              f"{CLAP_2022_BAR}; the CPU took {cpu_s:.1f} s); vs cli.process's batch "
              f"{c22_cli:.8f}", flush=True)
        _require(c22 >= CLAP_2022_BAR and c22_cli >= CLAP_2022_BAR,
                 f"CLAP-2022 card vs CPU cosine {c22}, vs cli.process {c22_cli}")
        del m22
        torch.cuda.empty_cache()

    *_, kern_fn, plain_fn = clap_rate.setup()
    with torch.no_grad():
        r = clap_rate.rates(kern_fn, plain_fn, batch=clap_rate.B)
    del kern_fn, plain_fn
    torch.cuda.empty_cache()
    print(f"[clap throughput] {smi}: device-resident 7-s clips at 44.1 kHz B={clap_rate.B}, in "
          f"turns (kernel, plain, plain, kernel): kernel path {r['kernel_ms']} ms/batch = "
          f"{r['kernel_clips_per_s']} clips/s; plain bf16 path {r['plain_ms']} ms/batch = "
          f"{r['plain_clips_per_s']} clips/s", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 25: the paper's comparison loop from disk
# ---------------------------------------------------------------------------

LOOP_PATIENTS = 40


def phase_loop(smi: str, root: str):
    """Phase 25: CP data preparation, continued pretraining, the probe,
    fine-tuning, checkpoint re-evaluation and the significance test, each
    through its entry point in one working directory (root, which phases
    26-28 go on using). A synthetic CirCor
    corpus through cli.process (operaCT, clap2023); pretrain/prepare.py
    writes the COLA and Audio-MAE manifests (their counts: the valid train +
    val clips); cli.pretrain takes a COLA epoch from the port's manifest on
    the train kernels; cli.linear_eval trains one seed's head and
    cli.finetune one operaCT model (1 epoch); cli.eval_ckpts re-tests both
    from cks/ (the head's AUROC within 1e-6 of the trained one; the
    fine-tuned model's float32 re-test printed beside its bf16 run);
    cli.significance model1=operaCT model2=clap2023: both score lists and a
    finite t and p."""
    import numpy as np

    from heart_murmur_detection_tpu_torch.audio import pipelines
    from heart_murmur_detection_tpu_torch.bench.process_time import write_circor
    from heart_murmur_detection_tpu_torch.cli import (eval_ckpts, finetune, linear_eval, pretrain,
                                                      process, significance)
    from heart_murmur_detection_tpu_torch.pretrain import prepare

    cwd = os.getcwd()
    fdir = "feature/circor_eval/"
    n_clips = write_circor(root, LOOP_PATIENTS, seed=SEED + 25)
    os.chdir(root)
    try:
        t0 = time.time()
        process.main(["dataset=circor", "pretrain=operaCT", "dim=768", "random_init=True",
                      "source_sr=4000"])
        process.main(["dataset=circor", "pretrain=clap2023", "random_init=True"])
        proc_s = time.time() - t0
        split = np.load(fdir + "train_test_split.npy")
        tv = [str(f) for f, s in zip(np.load(fdir + "sound_dir_loc.npy"), split)
              if s in ("train", "val")]
        want_cola = sum(pipelines.get_entire_signal(f, input_sec=8) is not None for f in tv)
        t0 = time.time()
        n_cola = prepare.preprocess_spectrogram_ssl(fdir, input_sec=8)
        n_mae = prepare.preprocess_spectrogram_ssl_audiomae(fdir, input_sec=10)
        prep_s = time.time() - t0
        _require(n_cola == want_cola and n_mae == len(tv),
                 f"prepared {n_cola} COLA / {n_mae} Audio-MAE clips of {len(tv)} train + val "
                 f"({want_cola} of them at least 8 s after trimming)")

        _reset_counts()  # just before the CP path
        t0 = time.time()
        ((_, history, _),) = pretrain.main([
            "encoder=htsat", "method=cola", "compute_dtype=bfloat16", "batch_size=16",
            "epoches=1", "seed=0", "title=loop", "device=cuda", "circor=True"])
        cp_s = time.time() - t0
        cp_counts = _all_counts()
        loss, steps = history[0]["train_loss"], history[0]["steps"]
        _require(np.isfinite(loss) and cp_counts["swin_attn_bwd"] > 0
                 and cp_counts["swin_mlp_bwd"] > 0,
                 f"COLA CP from the port's manifest: {history[0]}, launches {cp_counts}")

        t0 = time.time()
        ((lp,),) = linear_eval.main(["task=circor_murmurs", "pretrain=operaCT", "dim=768",
                                     "n_run=1"])
        ((ft,),) = finetune.main(["task=circor_murmurs", "pretrain=operaCT",
                                  "compute_dtype=bfloat16", "random_init=True", "n_run=1",
                                  "epochs=1", "device=cuda"])
        train_s = time.time() - t0
        t0 = time.time()
        ((re_lp,),) = eval_ckpts.main(["task=circor_murmurs", "pretrain=operaCT768",
                                       "head_only=True", "loss=weighted", "n_run=1"])
        ((re_ft,),) = eval_ckpts.main(["task=circor_murmurs", "pretrain=operaCT",
                                       "head_only=False", "loss=weighted", "batch_size=64",
                                       "epochs=1", "n_run=1"])
        eval_s = time.time() - t0
        t0 = time.time()
        s1, s2, (t, pv, _) = significance.main(["model1=operaCT", "dim1=768",
                                                "model2=clap2023"])
        sig_s = time.time() - t0
    finally:
        os.chdir(cwd)
    _require(abs(re_lp - lp) <= 1e-6, f"re-evaluated head AUROC {re_lp} vs trained {lp}")
    _require(np.isfinite(re_ft), f"re-evaluated fine-tuned AUROC {re_ft}")
    _require(len(s1) == len(s2) == 5 and bool(np.isfinite(s1 + s2).all())
             and bool(np.isfinite([t, pv]).all()), f"significance {s1} {s2} t {t} p {pv}")
    print(f"[loop] {n_clips} clips: cli.process operaCT + clap2023 {proc_s:.1f} s; "
          f"pretrain/prepare.py {n_cola} COLA and {n_mae} Audio-MAE spectrograms of "
          f"{len(tv)} train + val clips in {prep_s:.1f} s; cli.pretrain method=cola "
          f"compute_dtype=bfloat16 B=16, one epoch ({steps} steps) from the port's manifest in "
          f"{cp_s:.1f} s, loss {loss:.4f}, launches {cp_counts}", flush=True)
    print(f"[loop] cli.linear_eval seed 0 test AUROC {lp:.6f}, cli.eval_ckpts head_only=True "
          f"{re_lp:.6f} (|diff| {abs(re_lp - lp):.1e}, bar 1e-6); cli.finetune operaCT 1 epoch "
          f"bf16 test AUROC {ft:.6f}, cli.eval_ckpts head_only=False float32 re-test "
          f"{re_ft:.6f} (information); training {train_s:.1f} s, re-tests {eval_s:.1f} s; "
          f"cli.significance operaCT vs clap2023 in {sig_s:.1f} s: "
          + " ".join(f"{a:.4f}" for a in s1) + " vs " + " ".join(f"{a:.4f}" for a in s2)
          + f", t {t:.4f}, p {pv:.4g}; {smi}", flush=True)


# ---------------------------------------------------------------------------
# phases 26-28: the rest of the encoder zoo (no kernel of the repository:
# cuDNN and torch on the card, host numpy for openSMILE)
# ---------------------------------------------------------------------------

ZOO_BAR = 0.99999  # card vs CPU, the same float32 graph (TF32 off), per clip
# Two different clips' features must be farther apart than this (cosine) for
# ZOO_BAR to tell a right card path from one that gives the wrong features:
# 100 times the bar's own distance from 1.
ZOO_APART = 1 - 100 * (1 - ZOO_BAR)
# The EfficientNet's bf16 COLA steps against strict f32 from the same weights.
# On a random init its bf16 step is far from its f32 step in the JAX package
# too: about 3e-2 of the loss and a median gradient-leaf cosine of 0.98 on
# the batch of tests/test_torch_efficientnet.py::
# test_bf16_cola_step_stays_in_the_jax_class, which holds the port's bf16
# flow within twice the JAX package's distance on the CPU. On the card the
# two flows are held by the ratio rule of ROADMAP's precision classes, with
# float32 the reference of both bf16 flows and the same two graphs on the
# CPU the yardstick: over 3 steps, each of both flows taken from the same
# weights, the root mean square over the steps of the card's relative loss
# gap |bf16 - f32| / f32 no more than F32_RATIO_MEDIAN times the CPU's
# (floored at CE_LOSS_GAP_FLOOR), and the step-0 gradients' median over
# leaves of the (1 - cos) ratio card / CPU <= F32_RATIO_MEDIAN. A step's
# gap is not held to the CPU's one by one: at these weights the bf16 loss
# moves by a few 1e-2 with the rounding (the card's and the CPU's bf16
# losses of one step differ by up to 1.8e-2 of the loss, their f32 losses
# agree), so only its size over the steps is a property of the flow.
CE_LOSS_GAP_FLOOR = 1e-3


def _zero_launches(what: str, counts: dict):
    _require(not any(counts.values()), f"{what} launched repository kernels: {counts}")


def _calibrated_operace_ckpt(files: list, path: str) -> float:
    """The registry's seed-0 Cola(efficientnet) with every BatchNorm's
    running statistics set to those of the clips' mels (one train-mode pass
    on the card at momentum 0, drop-connect off), saved as a reference-layout
    checkpoint at path. At a random init with unit running statistics the
    EfficientNet's eval features are the running means' offsets and hardly
    depend on the input (tests/test_torch_efficientnet.py); calibrated, they
    do. -> seconds taken."""
    import torch

    from heart_murmur_detection_tpu_torch.audio import dsp
    from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor
    from heart_murmur_detection_tpu_torch.models import bn as bn_mod
    from heart_murmur_detection_tpu_torch.models import efficientnet as eff
    from heart_murmur_detection_tpu_torch.utils.precision import strict_f32

    t0 = time.time()
    ex = FeatureExtractor("operaCE", random_init=True, seed=0, device="cuda")
    wav, lengths = dsp.pad_batch([ex._clip_waveform(f) for f in files])
    mel, _ = dsp.mel_frontend(torch.from_numpy(wav).cuda(), torch.from_numpy(lengths).cuda())
    model, stats = ex.model, {}
    blocks = model.encoder.efficientnet._blocks
    drops = [blk.drop for blk in blocks]
    keep, eff.BN_MOMENTUM = eff.BN_MOMENTUM, 0.0
    try:
        for blk in blocks:
            blk.drop = 0.0
        with torch.no_grad(), strict_f32():
            model.encoder(mel, stats=stats)
    finally:
        eff.BN_MOMENTUM = keep
        for blk, d in zip(blocks, drops):
            blk.drop = d
    bn_mod.commit(stats)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"state_dict": {k: v.cpu() for k, v in model.state_dict().items()}}, path)
    return time.time() - t0


def phase_operace(smi: str, root: str) -> list:
    """Phase 26: operaCE from disk on phase 25's corpus. The OPERA-CE
    checkpoint at the registry's path is the seed-0 init with its
    BatchNorms calibrated on 12 of the corpus's clips
    (_calibrated_operace_ckpt). cli.process with its config defaults
    (pretrain operaCE, dim 1280, that checkpoint) and at dim 512, then
    cli.linear_eval with its defaults (5 seeds); the null baseline
    (null-efficientnet, random weights) the same way; no launch of a
    repository kernel; the 12 clips' features on the card against the same
    float32 graph on the CPU (TF32 off) at both dims, after checking that
    the clips' features differ from each other far beyond the bar. Returns
    the 5 probe AUROCs."""
    import numpy as np

    from heart_murmur_detection_tpu_torch.cli import linear_eval, process
    from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor
    from heart_murmur_detection_tpu_torch.extract.registry import (
        ENCODER_PATH_OPERA_CE_EFFICIENTNET)

    fdir = "feature/circor_eval/"
    ckpt = os.path.join(root, ENCODER_PATH_OPERA_CE_EFFICIENTNET)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        n = len(np.load(fdir + "sound_dir_loc.npy"))
        files = [os.path.join(root, str(f)) for f in np.load(fdir + "sound_dir_loc.npy")][:12]
        cal_s = _calibrated_operace_ckpt(files, ckpt)
        outs, secs = {}, {}
        _reset_counts()  # just before the operaCE path
        for dim in (1280, 512):
            t0 = time.time()
            (outs[dim],) = process.main(["dataset=circor"] + ([] if dim == 1280 else ["dim=512"]))
            secs[dim] = time.time() - t0
        t0 = time.time()
        ((*scores,),) = linear_eval.main(["task=circor_murmurs"])
        lp_s = time.time() - t0
        t0 = time.time()
        (null_out,) = process.main(["dataset=circor", "pretrain=null-efficientnet",
                                    "random_init=True"])
        null_s = time.time() - t0
        ((*null_scores,),) = linear_eval.main(["task=circor_murmurs",
                                               "pretrain=null-efficientnet"])
        counts = _all_counts()
        feats = {dim: np.load(outs[dim]) for dim in outs}
    finally:
        os.chdir(cwd)
    for dim, out in outs.items():
        _require(out.endswith(f"operaCE{dim}_feature.npy") and feats[dim].shape == (n, dim)
                 and bool(np.isfinite(feats[dim]).all()), f"operaCE{dim} features {out}")
    _require(null_out.endswith("null-efficientnet1280_feature.npy"), f"null features {null_out}")
    _zero_launches("operaCE extraction and probes", counts)
    for name, sc in (("operaCE1280", scores), ("null-efficientnet1280", null_scores)):
        _require(len(sc) == 5 and bool(np.isfinite(sc).all()), f"{name} test AUROCs {sc}")
    print(f"[operaCE] checkpoint calibrated on 12 clips in {cal_s:.1f} s; cli.process "
          f"dataset=circor (config defaults: pretrain operaCE, dim 1280, that checkpoint): {n} clips in {secs[1280]:.1f} s = {n / secs[1280]:.1f} clips/s "
          f"(16 kHz host path, every batch padded to the longest clip, the EfficientNet in "
          f"float32 on cuDNN); dim=512 {secs[512]:.1f} s = {n / secs[512]:.1f} clips/s; "
          f"null-efficientnet {null_s:.1f} s; repository kernel launches {sum(counts.values())}; "
          f"cli.linear_eval defaults (5 seeds) in {lp_s:.1f} s: test AUROC "
          + " ".join(f"{a:.4f}" for a in scores) + f"; null-efficientnet "
          + " ".join(f"{a:.4f}" for a in null_scores) + f"; {smi}", flush=True)
    for dim in (1280, 512):
        kw = dict(dim=dim, batch_size=16, ckpt_path=ckpt, pad0=True)
        card = FeatureExtractor("operaCE", device="cuda", **kw).extract_files(files)
        cpu = FeatureExtractor("operaCE", device="cpu", **kw).extract_files(files)
        # the bar can only fail a card path that gives another clip's (or a
        # wrongly framed clip's) features if the clips' features are far
        # apart: the closest two clips on the CPU stand well below it
        between = _per_clip_cos(np.repeat(cpu, len(cpu), 0), np.tile(cpu, (len(cpu), 1)))
        apart = float(between.reshape(len(cpu), len(cpu))[~np.eye(len(cpu), dtype=bool)].max())
        c = float(_per_clip_cos(card, cpu).min())
        cc = float(_per_clip_cos(card - card.mean(0), cpu - cpu.mean(0)).min())
        print(f"[operaCE] dim {dim}: {len(files)} clips' features on the card vs the same float32 "
              f"graph on the CPU (TF32 off), per-clip cosine min {c:.8f} (bar {ZOO_BAR}), of the "
              f"features less their mean over clips {cc:.8f}; the closest two clips' cosine on "
              f"the CPU {apart:.6f} (bar {ZOO_APART:.6g})", flush=True)
        _require(apart <= ZOO_APART, f"operaCE{dim} clips' features barely differ: {apart}")
        _require(c >= ZOO_BAR, f"operaCE{dim} card vs CPU cosine {c}")
    return list(scores)


def phase_operace_train(smi: str, root: str, dev, probe_scores: list):
    """Phase 27: operaCE training. cli.pretrain encoder=efficientnet
    compute_dtype=bfloat16 (B=16, one epoch) from phase 25's COLA manifest;
    3 steps of the bf16 path against the strict f32 path from the same
    weights, batches and generator (the bf16 path takes each step from the
    f32 path's weights), with dropout at 0.1 on the card (information) and
    without on the card and the CPU (the gate: the loss gaps and the step-0
    gradients of the two devices); the COLA and fine-tuning step times; cli.finetune
    with its defaults (operaCE, one seed, one epoch, float32) and
    cli.eval_ckpts of the probe head (within 1e-6 of phase 26's seed 0) and
    of the fine-tuned model (finite). No launch of a repository kernel."""
    import copy
    import math

    import numpy as np
    import torch

    from heart_murmur_detection_tpu_torch.cli import eval_ckpts, finetune, pretrain
    from heart_murmur_detection_tpu_torch.extract.registry import initialize_pretrained_model
    from heart_murmur_detection_tpu_torch.models import bn as bn_mod
    from heart_murmur_detection_tpu_torch.pretrain import cola_training as ct
    from heart_murmur_detection_tpu_torch.pretrain import steps
    from heart_murmur_detection_tpu_torch.pretrain.data import (
        OPTIMAL_MAX_LEN_COLA, MultiCorpusSampler, load_corpus)
    from heart_murmur_detection_tpu_torch.train import finetune as ft
    from heart_murmur_detection_tpu_torch.train.linear_eval import ClippedAdam

    cwd = os.getcwd()
    os.chdir(root)
    try:
        _reset_counts()  # just before the operaCE training paths
        t0 = time.time()
        ((_, history, _),) = pretrain.main([
            "encoder=efficientnet", "method=cola", "compute_dtype=bfloat16", "batch_size=16",
            "epoches=1", "seed=0", "title=ce", "device=cuda", "circor=True"])
        cp_s = time.time() - t0
        t0 = time.time()
        ((ft_auc,),) = finetune.main(["task=circor_murmurs", "random_init=True", "n_run=1",
                                      "epochs=1"])
        ft_s = time.time() - t0
        t0 = time.time()
        ((re_lp,),) = eval_ckpts.main(["task=circor_murmurs", "pretrain=operaCE1280",
                                       "head_only=True", "loss=weighted", "n_run=1"])
        ((re_ft,),) = eval_ckpts.main(["task=circor_murmurs", "head_only=False",
                                       "loss=weighted", "batch_size=64", "epochs=1", "n_run=1"])
        eval_s = time.time() - t0
        counts = _all_counts()
        corpus = load_corpus("circor", OPTIMAL_MAX_LEN_COLA["circor"])
        spec = np.load("feature/circor_eval/spectrogram_pad8.npy")
    finally:
        os.chdir(cwd)
    h = history[0]
    _require(all(math.isfinite(h[q]) for q in ("train_loss", "valid_loss")), f"CE CP {h}")
    _zero_launches("operaCE CP, fine-tuning and re-tests", counts)
    _require(abs(re_lp - probe_scores[0]) <= 1e-6,
             f"re-evaluated operaCE1280 head AUROC {re_lp} vs trained {probe_scores[0]}")
    _require(math.isfinite(ft_auc) and math.isfinite(re_ft), f"fine-tuned {ft_auc}, re-test {re_ft}")
    print(f"[operaCE train] cli.pretrain encoder=efficientnet compute_dtype=bfloat16 B=16, one "
          f"epoch from phase 25's manifest: {h['steps']} steps, {h['pairs']} pairs in "
          f"{h['train_seconds']:.2f} s (first step included), train loss {h['train_loss']:.4f} "
          f"valid {h['valid_loss']:.4f}, {cp_s:.1f} s all told; cli.finetune defaults (operaCE, "
          f"float32, 1 epoch) test AUROC {ft_auc:.6f} in {ft_s:.1f} s; cli.eval_ckpts "
          f"head_only=True {re_lp:.6f} vs trained {probe_scores[0]:.6f} (|diff| "
          f"{abs(re_lp - probe_scores[0]):.1e}, bar 1e-6), the fine-tuned model's float32 "
          f"re-test {re_ft:.6f}, in {eval_s:.1f} s; repository kernel launches "
          f"{sum(counts.values())}; {smi}", flush=True)

    sampler = MultiCorpusSampler([corpus], 16, seed=SEED + 27)
    batches = [tuple(torch.from_numpy(v).to(dev) for v in sampler.next_batch()[1])
               for _ in range(3)]
    base = initialize_pretrained_model("operaCE", random_init=True, seed=SEED).to(dev).train()

    def no_drop(model):
        """Dropout's rate is forward_backward's; drop-connect's is the blocks'."""
        for blk in model.encoder.efficientnet._blocks:
            blk.drop = 0.0
        return model

    def run(mm_dtype, weights=None, p_drop=0.1, n_steps=3, device=dev):
        """Losses and gradients of n_steps steps on device; with `weights`,
        each step starts from weights[i]."""
        model = copy.deepcopy(base) if p_drop else no_drop(copy.deepcopy(base))
        model.to(device)
        opt = steps.adam_with_epoch_decay(list(model.parameters()), 5)
        gen = torch.Generator(device=device).manual_seed(SEED + 27)
        losses, grads, states = [], [], []
        for i, (x1, x2) in enumerate(batches[:n_steps]):
            if weights is not None:
                model.load_state_dict(weights[i])
            states.append(copy.deepcopy(model.state_dict()))
            opt.zero_grad()
            loss, _, stats = ct.forward_backward(model, x1.to(device), x2.to(device), gen,
                                                 mm_dtype, "autograd", p_drop)
            grads.append({q: w.grad.detach().float().cpu().clone()
                          for q, w in model.named_parameters()})
            opt.step()
            bn_mod.commit(stats)
            losses.append(float(loss))
        return losses, grads, states

    # with dropout and drop-connect at the protocol's 0.1 (information)
    lf, _, wf = run(torch.float32)
    lb, _, _ = run(torch.bfloat16, weights=wf)
    # the gate: dropout and drop-connect off (deterministic), every step of
    # both flows on both devices from the card's f32 path's weights, so that
    # the four losses of a step share weights and batch
    lf0, (gf, *_), wf0 = run(torch.float32, p_drop=0.0)
    lb0, (gb, *_), _ = run(torch.bfloat16, weights=wf0, p_drop=0.0)
    lfh, (gfh, *_), _ = run(torch.float32, weights=wf0, p_drop=0.0, device="cpu")
    lbh, (gbh, *_), _ = run(torch.bfloat16, weights=wf0, p_drop=0.0, device="cpu")
    rel = [abs(a - b) / abs(b) for a, b in zip(lb, lf)]
    gap = [(a - b) / abs(b) for a, b in zip(lb0, lf0)]
    gap_h = [(a - b) / abs(b) for a, b in zip(lbh, lfh)]
    rms = lambda v: math.sqrt(sum(x * x for x in v) / len(v))
    gap_r = rms(gap) / max(rms(gap_h), CE_LOSS_GAP_FLOOR)
    cos = {q: _cos(gb[q], gf[q]) for q in gf if float(gf[q].norm()) > 0}
    cos_h = {q: _cos(gbh[q], gfh[q]) for q in cos}
    ratio = {q: (1 - cos[q]) / max(1 - cos_h[q], 1e-7) for q in cos}
    vals = sorted(cos.values())
    med, lo = vals[len(vals) // 2], min(cos, key=cos.get)
    med_h = sorted(cos_h.values())[len(cos_h) // 2]
    med_r = sorted(ratio.values())[len(ratio) // 2]
    print(f"[operaCE train] 3 COLA steps B=16 x {batches[0][0].shape[1]} frames, the bf16 path "
          f"(bf16 convolutions, float32 BatchNorms) each from the strict f32 path's weights, same "
          f"batches and generator, dropout and drop-connect 0.1: losses bf16 "
          f"{[round(v, 5) for v in lb]} f32 {[round(v, 5) for v in lf]}, max rel diff "
          f"{max(rel):.4g} (information: the ROADMAP's 1e-3 is under the JAX package's own "
          f"bf16-vs-f32 class here); dropout and drop-connect off, the same graphs on the card and "
          f"the CPU from the card's f32 weights: (bf16 - f32) / f32 loss card "
          f"{[round(v, 6) for v in gap]} CPU {[round(v, 6) for v in gap_h]} (f32 losses card "
          f"{[round(v, 5) for v in lf0]} CPU {[round(v, 5) for v in lfh]}), root mean square "
          f"card {rms(gap):.6f} / CPU {rms(gap_h):.6f} = {gap_r:.3f} (bar {F32_RATIO_MEDIAN}); "
          f"step-0 gradient cosines bf16 vs f32 over {len(cos)} "
          f"leaves: card median {med:.6f}, min {cos[lo]:.6f} ({lo}), "
          f"{sum(v < GRAD_FLOOR for v in vals)} under {GRAD_FLOOR}; CPU median {med_h:.6f}; "
          f"(1 - cos) card / CPU median {med_r:.3f} (bar {F32_RATIO_MEDIAN})", flush=True)
    _require(gap_r <= F32_RATIO_MEDIAN,
             f"CE bf16 - f32 loss gaps card {gap} vs CPU {gap_h}: rms ratio {gap_r}")
    _require(med_r <= F32_RATIO_MEDIAN,
             f"CE bf16 step-0 gradients: median (1 - cos) ratio card / CPU {med_r}")

    # step times: COLA at the smoke's B=16 and the protocol's B=64 (circor's
    # 251-frame crops); fine-tuning at the protocol's B=64 of (256, 64) mels
    times = []
    for B in (16, 64):
        x1, x2 = (torch.from_numpy(v).to(dev)
                  for v in MultiCorpusSampler([corpus], B, seed=SEED + 28).next_batch()[1])
        for mm in (torch.bfloat16, torch.float32):
            model = copy.deepcopy(base)
            opt = steps.adam_with_epoch_decay(list(model.parameters()), 5)
            gen = torch.Generator(device=dev).manual_seed(SEED + 28)
            ms = _time_ms(lambda: ct.train_step(model, opt, x1, x2, gen, mm, "autograd", 0.1),
                          iters=5, warm=2)
            times.append(f"B={x1.shape[0]} {str(mm)[6:]} {ms:.2f} ms")
            del model, opt
    xb = torch.from_numpy(np.resize(spec, (64,) + spec.shape[1:]).astype(np.float32)).to(dev)
    yb = torch.zeros(64, dtype=torch.int64, device=dev)
    yb[::2] = 1
    valid, cw = torch.ones(64, device=dev), torch.ones(2, device=dev)
    for mm in (torch.float32, torch.bfloat16):
        m = ft.EncoderClassifier("efficientnet", 2, "linear", 1280,
                                 generator=torch.Generator().manual_seed(SEED)).to(dev).train()
        opt = ClippedAdam(list(m.parameters()), 3, 1e-4, 0.99, 1.0)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        ms = _time_ms(lambda: ft.train_step(m, opt, xb, yb, valid, cw, gen, mm, "autograd", 1e-4),
                      iters=5, warm=2)
        times.append(f"fine-tuning B=64 x 256 frames {str(mm)[6:]} {ms:.2f} ms")
        del m, opt
    print(f"[operaCE train] steady-state step times, {smi}: COLA "
          + "; ".join(times), flush=True)


def _timed_finetune(argv: list):
    """cli.finetune with each train step timed (synchronised): (test AUROC,
    step ms list, launches, seconds)."""
    import torch

    from heart_murmur_detection_tpu_torch.cli import finetune
    from heart_murmur_detection_tpu_torch.train import finetune as ft

    orig, ms = ft.train_step, []

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return out

    ft.train_step = timed
    _reset_counts()
    t0 = time.time()
    try:
        ((auc,),) = finetune.main(argv)
    finally:
        ft.train_step = orig
    return auc, ms, _all_counts(), time.time() - t0


def phase_baselines(smi: str, root: str):
    """Phase 28: the baselines on phase 25's corpus. cli.process
    pretrain=vggish (random weights) and cli.linear_eval (5 seeds); 4
    clips' VGGish features on the card against the CPU's float32 graph;
    pretrain=opensmile (host numpy emobase): rows equal to the functions'
    own on 3 files, the provenance sidecar native-emobase; one fine-tuning
    run each of CLAP-2022, CLAP-2023 and HeAR through cli.finetune
    (random_init, 2 epochs, float32): finite AUROCs, step times; no launch
    of a repository kernel."""
    import math

    import numpy as np

    from heart_murmur_detection_tpu_torch.cli import linear_eval, process
    from heart_murmur_detection_tpu_torch.models import vggish

    fdir = "feature/circor_eval/"
    cwd = os.getcwd()
    os.chdir(root)
    try:
        n = len(np.load(fdir + "sound_dir_loc.npy"))
        _reset_counts()  # just before the baselines' paths
        t0 = time.time()
        (vout,) = process.main(["dataset=circor", "pretrain=vggish", "random_init=True"])
        v_s = time.time() - t0
        ((*vscores,),) = linear_eval.main(["task=circor_murmurs", "pretrain=vggish"])
        t0 = time.time()
        (oout,) = process.main(["dataset=circor", "pretrain=opensmile"])
        o_s = time.time() - t0
        counts = _all_counts()
        with open(fdir + "opensmile_feature.provenance.json") as f:
            prov = json.load(f)
        files = [os.path.join(root, str(f)) for f in np.load(fdir + "sound_dir_loc.npy")]
        vfeat, ofeat = np.load(vout), np.load(oout)
        runs = {}
        for pretrain in ("clap", "clap2023", "hear"):
            runs[pretrain] = _timed_finetune(["task=circor_murmurs", f"pretrain={pretrain}",
                                              "random_init=True", "n_run=1", "epochs=2"])
    finally:
        os.chdir(cwd)
    _require(vfeat.shape == (n, 128) and bool(np.isfinite(vfeat).all()), f"vggish {vfeat.shape}")
    _require(ofeat.shape == (n, 988) and bool(np.isfinite(ofeat).all()), f"opensmile {ofeat.shape}")
    _require(len(vscores) == 5 and bool(np.isfinite(vscores).all()), f"vggish AUROCs {vscores}")
    _require(prov == {"impl": "native-emobase"}, f"opensmile provenance {prov}")
    _zero_launches("vggish and opensmile", counts)
    cpu = vggish.extract_vgg_feature(files[:4], random_init=True, device="cpu")
    cv = float(_per_clip_cos(vfeat[:4], cpu).min())
    same = all(np.array_equal(ofeat[i], np.asarray(vggish.extract_opensmile_features(files[i]))
                              .reshape(-1)) for i in range(3))
    print(f"[baselines] cli.process pretrain=vggish random_init=True: {n} clips in {v_s:.1f} s = "
          f"{n / v_s:.1f} clips/s (host framing at 16 kHz, the network in float32 on cuDNN); "
          f"cli.linear_eval pretrain=vggish (5 seeds): test AUROC "
          + " ".join(f"{a:.4f}" for a in vscores)
          + f"; 4 clips card vs CPU per-clip cosine min {cv:.8f} (bar {ZOO_BAR}); "
          f"pretrain=opensmile (host numpy emobase, {prov['impl']}): {n} clips in {o_s:.1f} s = "
          f"{n / o_s:.1f} clips/s, 3 files' rows equal to the functions' own: {same}; "
          f"repository kernel launches {sum(counts.values())}; {smi}", flush=True)
    _require(cv >= ZOO_BAR, f"vggish card vs CPU cosine {cv}")
    _require(same, "opensmile features differ from the host functions'")
    for pretrain, (auc, ms, c, secs) in runs.items():
        _zero_launches(f"cli.finetune pretrain={pretrain}", c)
        _require(math.isfinite(auc) and len(ms) >= 2, f"{pretrain} fine-tuning {auc}, steps {ms}")
        print(f"[baselines] cli.finetune pretrain={pretrain} random_init=True (float32, 2 epochs): "
              f"test AUROC {auc:.6f}, {len(ms)} steps, first {ms[0]:.1f} ms, then median "
              f"{sorted(ms[1:])[len(ms[1:]) // 2]:.1f} ms/step, {secs:.1f} s with the cache and "
              f"predictions; repository kernel launches {sum(c.values())}; {smi}", flush=True)


# ---------------------------------------------------------------------------
# phases 29-30: the legacy OPERA respiratory benchmark from disk (K1-K4 and
# K5-K7 on extraction, K8 / K9 on continued pretraining)
# ---------------------------------------------------------------------------

# the probe tasks of phase 29 (cli.linear_eval task=...) and their feature dirs
RESP_TASKS = {"copd": "feature/copd_eval/", "icbhidisease": "feature/icbhidisease_eval/",
              "snoring": "feature/snoring_eval/"}
RESP_CORPORA = ("copd", "icbhi", "ssbpr", "nosemic", "mmlung", "hf_lung")  # phases 29-30
RESP_CIRCOR_PATIENTS = 30  # the 16-kHz CirCor corpus of the loader comparison
LOOCV_PERTURBATIONS = 3  # CPU runs on features moved one ulp, for the spread


class _Recording:
    """Within the block, every FeatureExtractor the port builds is recorded
    in `made`, and the seconds its extract_files calls take (the model's
    init left out) add up in `seconds`."""

    def __enter__(self):
        from heart_murmur_detection_tpu_torch.extract import extract as ext

        self.ext, self.base, self.made, self.seconds = ext, ext.FeatureExtractor, [], 0.0
        rec = self

        class Recorded(self.base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                rec.made.append(self)

            def extract_files(self, paths):
                t0 = time.time()
                try:
                    return super().extract_files(paths)
                finally:
                    rec.seconds += time.time() - t0

        ext.FeatureExtractor = Recorded
        return self

    def __exit__(self, *exc):
        self.ext.FeatureExtractor = self.base


def _recorded_extract(fdir: str, pretrain: str, dim: int):
    """extract_and_save on one feature dir at the CLI's window; returns (saved
    path, the FeatureExtractor it built, launch counts, seconds of the call,
    seconds of extract_files alone)."""
    from heart_murmur_detection_tpu_torch.data.processors import common
    from heart_murmur_detection_tpu_torch.extract.registry import default_input_sec

    with _Recording() as rec:
        _reset_counts()  # just before the extraction path
        t0 = time.time()
        out = common.extract_and_save(fdir, pretrain, input_sec=default_input_sec(pretrain),
                                      dim=dim, random_init=True)
        secs = time.time() - t0
        counts = _all_counts()
    return out, rec.made[0], counts, secs, rec.seconds


def _extraction_counts_ok(ex, paths, counts) -> tuple:
    """The launches one extraction implies: an operaCT batch runs 12
    swin_attn + 12 swin_mlp, an operaGT batch 12 of each ViT kernel; the
    batches counted from the files (operaCT) or from their kept chunks
    (operaGT: the >= 16-frame gate of _extract_chunked). Returns (ok,
    batches, what each kernel should read)."""
    import math

    if ex.is_mae:
        n = sum(1 for p in paths for c in ex._chunks(p) if len(c) // 512 + 1 >= 16)
        want = {"vit_qkv": 12, "vit_attn": 12, "vit_proj": 12, "vit_mlp": 12}
    else:
        n = len(paths)
        want = {"swin_attn": 12, "swin_mlp": 12}
    batches = math.ceil(n / ex.batch_size)
    want = {k: v * batches for k, v in want.items()}
    ok = ex.n_dispatched == batches and all(counts[k] == want.get(k, 0) for k in counts)
    return ok, batches, want


def phase_respiratory(smi: str, root: str):
    """Phase 29: the legacy respiratory benchmark from disk in `root`. The
    corpora (bench/resp_corpora.py: COPD at 4 kHz, ICBHI at 4 / 10 / 44.1
    kHz, SSBPR, NoseMic and MMLung at 16 kHz; an empty ICBHI diagnosis cell,
    a repeated key, MMLung's integer column and gapped column); the
    processors, through utils/table.py; extract_and_save
    with operaCT (whole clips: the native loader for 16-kHz WAVs, its Python
    route for the rest) and operaGT on each feature dir, with exact launch
    counts; cli.linear_eval on copd, icbhidisease and snoring (5 seeds,
    finite AUROCs); the two LOOCV tasks (folds = subjects, finite MAE /
    MAPE); the NoseMic LOOCV on the card against the CPU from the same
    seeded heads, at twice the spread that one-ulp moves of the features
    give on the CPU; cli.process clips/s through the native loader and the
    Python decoder, in turns (information)."""
    import numpy as np
    import torch

    from heart_murmur_detection_tpu_torch.bench.process_time import write_circor
    from heart_murmur_detection_tpu_torch.bench.resp_corpora import write_resp_corpora
    from heart_murmur_detection_tpu_torch.cli import linear_eval, process
    from heart_murmur_detection_tpu_torch.data.processors import respiratory as resp
    from heart_murmur_detection_tpu_torch.train import legacy_tasks as lt
    from heart_murmur_detection_tpu_torch.utils import native

    t_phase = time.time()
    written, mm_table = write_resp_corpora(root, seed=SEED + 29, corpora=RESP_CORPORA)
    n_mm = len(mm_table["ID"])  # participants: a deep breath and a vowel each
    cwd = os.getcwd()
    os.chdir(root)
    try:
        t0 = time.time()
        resp.copd_preprocess_split()
        resp.icbhi_process_disease()
        resp.ssbpr_preprocess()
        resp.nosemic_process_label()
        resp.mmlung_process_label()
        mm_paths = resp.mmlung_sound_dirs()["Deep_Breath_file"]
        np.save("feature/mmlung_eval/sound_dir_loc.npy", np.asarray(mm_paths))
        proc_s = time.time() - t0
        splits = {
            "copd": np.load("feature/copd_eval/train_test_split.npy"),
            "icbhidisease": np.load("feature/icbhidisease_eval/split.npy"),
            "snoring": np.load("feature/snoring_eval/labels.npy"),
            "nosemic": np.load("feature/nosemic_eval/uids.npy"),
            "mmlung": np.load("feature/mmlung_eval/label.npy"),
        }
        want_n = {"copd": written["copd"], "icbhidisease": written["icbhi"],
                  "snoring": written["ssbpr"] - written["ssbpr"] // 6,
                  "nosemic": written["nosemic"], "mmlung": n_mm}
        dirs = {**RESP_TASKS, "nosemic": "feature/nosemic_eval/", "mmlung": "feature/mmlung_eval/"}
        files = {t: [str(f) for f in np.load(d + "sound_dir_loc.npy")] for t, d in dirs.items()}
        for t, n in want_n.items():
            _require(len(files[t]) == len(splits[t]) == n,
                     f"{t}: {len(files[t])} files, {len(splits[t])} split / label rows, want {n}")
        na = (int((np.load("feature/icbhidisease_eval/labels.npy") == "nan").sum()),
              int(np.isnan(splits["mmlung"][:, 2]).sum()))
        _require(na == (3, 1), f"empty metadata cells read as (ICBHI 'nan' labels, MMLung NaN "
                               f"FEV1/FVC) {na}, want (3, 1)")
        tally = {t: {str(k): int(v) for k, v in zip(*np.unique(splits[t], return_counts=True))}
                 for t in ("copd", "icbhidisease")}
        print(f"[resp] corpora {written} written and processed in {time.time() - t_phase:.1f} s "
              f"(processors {proc_s:.2f} s): files a task "
              f"{ {t: len(v) for t, v in files.items()} } = the processors' outputs; splits "
              f"{tally}; snoring "
              f"labels {sorted(set(splits['snoring'].tolist()))}; NoseMic subjects "
              f"{len(set(splits['nosemic'].tolist()))}", flush=True)

        # extraction: operaCT and operaGT on each feature dir
        for t, d in dirs.items():
            for pretrain, dim in (("operaCT", 768), ("operaGT", 384)):
                out, ex, counts, secs, ex_s = _recorded_extract(d, pretrain, dim)
                feats = np.load(out)
                ok, batches, want = _extraction_counts_ok(ex, files[t], counts)
                _require(ok and feats.shape == (len(files[t]), dim)
                         and bool(np.isfinite(feats).all()),
                         f"{t} {pretrain}: {feats.shape}, {ex.n_dispatched} batches dispatched, "
                         f"launches {counts} (want {want} over {batches} batches)")
                routes = ex.route_counts if not ex.is_mae else "chunked (Python decoder)"
                if t == "mmlung":  # the reference's per-modality feature name
                    os.replace(out, d + f"Deep_Breath_file_{pretrain}{dim}_feature.npy")
                print(f"[resp] {t} {pretrain}: {len(files[t])} files in {secs:.2f} s, "
                      f"extract_files {ex_s:.2f} s = {len(files[t]) / ex_s:.1f} clips/s (the "
                      f"model's init left out); routes {routes}; {batches} batches, launches "
                      f"{ {k: v for k, v in counts.items() if v} } (exact)", flush=True)
                if t in ("icbhidisease", "snoring") and not ex.is_mae:
                    want_native = t == "snoring"
                    _require((ex.route_counts["native"] == len(files[t])) == want_native
                             and sum(ex.route_counts.values()) == len(files[t]),
                             f"{t} routes {ex.route_counts}")

        # the probes: 5 seeds of each task
        for t in RESP_TASKS:
            for pretrain, dim in (("operaCT", 768),) + ((("operaGT", 384),) if t == "copd" else ()):
                t0 = time.time()
                (scores,) = linear_eval.main([f"task={t}", f"pretrain={pretrain}", f"dim={dim}",
                                              "n_run=5"])
                _require(len(scores) == 5 and bool(np.isfinite(scores).all()),
                         f"{t} {pretrain} test AUROCs {scores}")
                print(f"[resp] cli.linear_eval task={t} pretrain={pretrain}{dim}: test AUROC "
                      + " ".join(f"{a:.4f}" for a in scores)
                      + f" (mean {np.mean(scores):.4f}) in {time.time() - t0:.1f} s", flush=True)

        # the LOOCV regression tasks
        n_subjects = len(set(splits["nosemic"].tolist()) & set(lt.NOSEMIC_UIDS))
        loocv = {}
        for task, extra, folds in (("rr", [], n_subjects),
                                   ("spirometry", ["label=FVC", "modality=breath"],
                                    n_mm)):
            t0 = time.time()
            ((maes, mapes),) = linear_eval.main(["LOOCV=True", f"task={task}", "head=mlp",
                                                 "pretrain=operaCT", "dim=768", *extra])
            secs = time.time() - t0
            _require(len(maes) == len(mapes) == folds and bool(np.isfinite(maes + mapes).all()),
                     f"LOOCV {task}: {len(maes)} folds (want {folds}), MAE {maes}")
            loocv[task] = maes
            print(f"[resp] cli.linear_eval LOOCV=True task={task}: {len(maes)} folds (= "
                  f"{'subjects' if task == 'rr' else 'recordings'}) in {secs:.1f} s "
                  f"({secs / len(maes) * 1e3:.0f} ms a fold on the card); MAE mean "
                  f"{np.mean(maes):.4f} +- {np.std(maes):.4f}, MAPE mean {np.mean(mapes):.4f}",
                  flush=True)

        # the NoseMic LOOCV, card vs CPU (the heads from the same seeded
        # generator on both); the spread: the CPU run against CPU runs on
        # features each moved one ulp, up or down at random
        x = np.load("feature/nosemic_eval/operaCT768_feature.npy")
        kw = dict(head="mlp", l2_strength=1e-1, epochs=64, batch_size=64, lr=1e-4)
        cpu, _ = lt.linear_evaluation_nosemic(use_feature="operaCT768", device="cpu", **kw)
        r = np.random.default_rng(SEED + 29)
        spread = 0.0
        for k in range(LOOCV_PERTURBATIONS):
            sign = np.where(r.random(x.shape) < 0.5, -np.inf, np.inf).astype(np.float32)
            np.save(f"feature/nosemic_eval/operaCT768ulp{k}_feature.npy", np.nextafter(x, sign))
            pert, _ = lt.linear_evaluation_nosemic(use_feature=f"operaCT768ulp{k}", device="cpu",
                                                   **kw)
            spread = max(spread, float(np.max(np.abs(np.subtract(pert, cpu)))))
        gap = float(np.max(np.abs(np.subtract(loocv["rr"], cpu))))
        if spread > 0:
            print(f"[resp] NoseMic LOOCV, card vs CPU over {len(cpu)} folds: max |MAE gap| "
                  f"{gap:.3e}, bar {2 * spread:.3e} (twice the spread {spread:.3e} of "
                  f"{LOOCV_PERTURBATIONS} CPU runs on features moved one ulp)", flush=True)
            _require(gap <= 2 * spread, f"NoseMic LOOCV card vs CPU {gap} > 2 x {spread}")
        else:
            print(f"[resp] NoseMic LOOCV, card vs CPU: max |MAE gap| {gap:.3e}; the spread of "
                  f"one-ulp feature moves read 0 (not measurable): gated on finite folds "
                  f"and their count only", flush=True)
        _require(len(cpu) == len(loocv["rr"]) and bool(np.isfinite(cpu).all()),
                 f"NoseMic LOOCV on the CPU {cpu}")

        # cli.process clips/s through the native loader and the Python
        # decoder, in turns, on a 16-kHz CirCor corpus (information)
        n_clips = write_circor(root, RESP_CIRCOR_PATIENTS, seed=SEED + 29, sr=16000)
        argv = ["dataset=circor", "pretrain=operaCT", "dim=768", "random_init=True"]
        load_clip = native.load_clip

        def python_only(*a, **k):
            raise ValueError("the Python decoder's turn")

        rates = {"native": [], "python": []}
        try:
            for route in ("native", "python", "python", "native"):
                native.load_clip = load_clip if route == "native" else python_only
                with _Recording() as rec:
                    t0 = time.time()
                    process.main(argv)
                    secs = time.time() - t0
                rates[route].append((n_clips / secs, n_clips / rec.seconds))
                _require(rec.made[-1].route_counts[route] == n_clips,
                         f"{route} turn routes {rec.made[-1].route_counts}")
        finally:
            native.load_clip = load_clip
        fmt = lambda r: " / ".join(f"{a:.1f} ({b:.1f})" for a, b in r)
        print(f"[resp] cli.process dataset=circor pretrain=operaCT (16 kHz, {n_clips} clips, "
              f"random_init), clips/s in turns, the whole CLI (extract_files alone): native "
              f"loader {fmt(rates['native'])}, Python decoder {fmt(rates['python'])} "
              f"(information); {smi}", flush=True)
    finally:
        os.chdir(cwd)
    torch.cuda.empty_cache()
    print(f"[resp] phase 29 took {time.time() - t_phase:.1f} s", flush=True)


def phase_resp_cp(smi: str, root: str):
    """Phase 30: respiratory continued pretraining from phase 29's corpora in
    `root`. pretrain/prepare.py writes the ICBHI whole-recording and
    cycle manifests and HF_Lung's (their counts: the valid clips); then
    cli.pretrain encoder=htsat method=cola (icbhi + hf_lung, crops of 50 and
    200 frames resized to the HTS-AT's 1024) and method=mae (icbhicycle +
    hf_lung, 64 and 256 frames padded to (256, 64)) at B=16, one epoch each
    on the train kernels: the launches of K8's and K9's kernels exactly as
    many a step as phases 8 and 16 read at their crops, finite losses, step
    ms (information)."""
    import math

    import numpy as np

    from heart_murmur_detection_tpu_torch.audio import icbhi, pipelines
    from heart_murmur_detection_tpu_torch.cli import pretrain
    from heart_murmur_detection_tpu_torch.models import vit_mae
    from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig
    from heart_murmur_detection_tpu_torch.pretrain import prepare

    t_phase = time.time()
    cwd = os.getcwd()
    os.chdir(root)
    try:
        d = "datasets/icbhi/ICBHI_final_database/"
        wavs = sorted(d + f for f in os.listdir(d) if f.endswith(".wav"))
        hf = sorted(os.path.join(dp, f) for sub in ("HF_Lung_V1-master", "HF_Lung_V1_IP-main")
                    for dp, _, fs in os.walk("datasets/hf_lung/" + sub + "/train")
                    for f in fs if f.endswith(".wav"))
        t0 = time.time()
        n_entire = prepare.preprocess_icbhi_entire()
        n_cycles = prepare.preprocess_icbhi_cycles()
        n_hf = prepare.preprocess_hflung_ssl()
        prep_s = time.time() - t0
        ann = icbhi.get_annotations("cycle", d)
        want_cycles = sum(
            pipelines.get_entire_signal("", input_sec=2, spectrogram=False, yt=c) is not None
            for w in wavs for c, _ in icbhi.get_individual_cycles(
                "cycle", ann[os.path.basename(w)[:-4]], d, os.path.basename(w)[:-4], 16000, 2))
        want_entire = sum(pipelines.get_entire_signal(w, input_sec=8) is not None for w in wavs)
        want_hf = sum(pipelines.get_entire_signal(w, input_sec=8) is not None for w in hf)
        manifests = {"icbhi": "datasets/icbhi/entire_spec_filenames.npy",
                     "icbhicycle": "datasets/icbhi/cycle_spec_pad2_name.npy",
                     "hf_lung": "datasets/hf_lung/entire_spec_filenames.npy"}
        sizes = {k: len(np.load(v)) for k, v in manifests.items()}
        _require((n_entire, n_cycles, n_hf) == (want_entire, want_cycles, want_hf)
                 == (sizes["icbhi"], sizes["icbhicycle"], sizes["hf_lung"]),
                 f"manifests {sizes}, returns {(n_entire, n_cycles, n_hf)}, valid clips "
                 f"{(want_entire, want_cycles, want_hf)}")
        # the CP corpora: ICBHI keeps its official train split; 10% of each
        # for validation (ceil)
        train = {"icbhi": int((np.load("datasets/icbhi/entire_spec_split.npy") == "train").sum()),
                 "icbhicycle": int((np.load("datasets/icbhi/cycle_spec_split.npy") == "train").sum()),
                 "hf_lung": sizes["hf_lung"]}
        val = {k: math.ceil(0.1 * v) for k, v in train.items()}
        print(f"[resp cp] pretrain/prepare.py in {prep_s:.1f} s: manifests {sizes} = the valid "
              f"clips (ICBHI {len(wavs)} recordings, HF_Lung {len(hf)}); CP train rows {train}, "
              f"validation {val}", flush=True)

        B = 16
        _reset_counts()  # just before the COLA path
        ((_, hist, _),) = pretrain.main([
            "encoder=htsat", "method=cola", "compute_dtype=bfloat16", f"batch_size={B}",
            "epoches=1", "seed=0", "title=resp", "device=cuda", "icbhi=True", "hf_lung=True"])
        counts = _all_counts()
        h = hist[0]
        n_val = sum(math.ceil(val[c] / B) for c in ("icbhi", "hf_lung"))
        per_step = {"swin_attn_bwd": 20, "swin_mlp_bwd": 20, "swin_wgrad": 80,
                    "swin_reduce": _reduce_per_step(HTSATConfig())}
        ok = all(counts[q] == v * h["steps"] for q, v in per_step.items())
        ok &= counts["swin_attn"] == counts["swin_mlp"] == 20 * h["steps"] + 24 * n_val
        _require(ok, f"COLA launch counts {counts} for {h['steps']} steps and {n_val} eval "
                     f"batches (want {per_step} a step)")
        _require(all(math.isfinite(h[q]) for q in ("train_loss", "valid_loss")), f"losses {h}")
        print(f"[resp cp] cli.pretrain method=cola icbhi + hf_lung (crops 50 / 200 frames), B={B}: "
              f"{h['steps']} steps in {h['train_seconds']:.2f} s = "
              f"{h['train_seconds'] / h['steps'] * 1e3:.1f} ms a step (first included); train loss "
              f"{h['train_loss']:.4f} valid {h['valid_loss']:.4f}; launches {counts} ({per_step} a "
              f"step, 20 + 20 forward a step and 24 an eval batch: phase 8's)", flush=True)

        gt_cfg = vit_mae.mae_vit_small_config(mask_ratio=0.7)
        _reset_counts()  # just before the MAE path
        ((_, hist, _),) = pretrain.main([
            "method=mae", "compute_dtype=bfloat16", f"batch_size={B}", "epoches=1", "seed=0",
            "title=resp_mae", "device=cuda", "icbhicycle=True", "hf_lung=True"])
        counts = _all_counts()
        n_val = sum(val[c] // B for c in ("icbhicycle", "hf_lung"))  # drop_last
        _mae_cp_report(f"[resp cp] cli.pretrain method=mae icbhicycle + hf_lung (64 / 256 frames "
                       f"padded to 256 x 64), B={B}, {smi}", hist[0], counts, gt_cfg,
                       _mae_per_step(gt_cfg), n_val)
        print(f"[resp cp] MAE step {hist[0]['train_seconds'] / hist[0]['steps'] * 1e3:.1f} ms "
              f"(first included); phase 30 took {time.time() - t_phase:.1f} s", flush=True)
    finally:
        os.chdir(cwd)


DP_STEPS = 2  # phase 31's COLA steps
DP_CLIPS = 16  # phase 31's extraction: 10-s clips, one batch
DP_NOTE = "two ranks share one H100; not a scaling figure"
DP_CLI_BATCH = 30  # phase 31's cli.pretrain epoch: 9 steps of 270 clips, one val batch of 30


def _dp_data():
    """Phase 31's inputs, made alike in every process: DP_STEPS COLA pairs
    at phase 8's circor crop (B=64 x 251 x 64, phase 8's value range), an
    Audio-MAE batch (B=64 x 1024 x 128), and DP_CLIPS 10-s waveforms at
    16 kHz."""
    import numpy as np

    r = np.random.default_rng(SEED + 40)
    mel = lambda: (r.standard_normal((B_TRAIN, 251, 64)) * 10 - 40).astype(np.float32)
    cola = [(mel(), mel()) for _ in range(DP_STEPS)]
    mae = r.standard_normal((B_TRAIN, 1024, 128)).astype(np.float32)
    wavs = [(0.1 * r.standard_normal(160000)).astype(np.float32) for _ in range(DP_CLIPS)]
    return cola, mae, wavs


def _dp_cola(mesh, dev, impl="kernel", zero=False, time_it=False):
    """DP_STEPS steps of the trainer's COLA step (bench/dp_scale.py::
    cola_steps: cola_training.train_step on the full-width operaCT, seed
    SEED, DropPath and dropout off) on this rank's rows: (losses, step-0
    summed gradients on the CPU, launch counts of the steps, step ms or
    None)."""
    import torch

    from heart_murmur_detection_tpu_torch.bench import dp_scale
    from heart_murmur_detection_tpu_torch.pretrain import cola_training as ct

    run = dp_scale.cola_steps(mesh, dev, _dp_data()[0], impl, zero, SEED,
                              before=_reset_counts)  # counts from 0 just before the steps
    torch.cuda.synchronize()
    counts = _all_counts()
    ms = None
    if time_it:
        x1, x2 = run["batches"][0]
        ms = _time_ms(lambda: ct.train_step(run["model"], run["opt"], x1, x2, None,
                                            torch.bfloat16, impl, 0.0, mesh, run["zero"]),
                      iters=3, warm=1)
    return run["losses"], run["grads"], counts, ms


def _dp_mae(mesh, dev):
    """One Audio-MAE CP step (K9) of the trainer (mae_training.batch_rows,
    steps.mae_train_step) on this rank's rows of the global batch, the
    masking noise drawn from a generator on the card seeded SEED: (loss,
    step-0 summed gradients, the global batch's masks as every rank's
    noise rows form them, counts)."""
    import torch

    from heart_murmur_detection_tpu_torch.models import vit_mae
    from heart_murmur_detection_tpu_torch.parallel.mesh import gather_objects
    from heart_murmur_detection_tpu_torch.pretrain import mae_training, steps

    cfg = vit_mae.audiomae_base_config(mask_ratio=0.7)
    model = vit_mae.MaskedAutoencoderViT(cfg, decoder=True)
    vit_mae.init_weights(model, torch.Generator().manual_seed(SEED))
    model.to(dev).train()
    opt = steps.adam_with_epoch_decay(list(model.parameters()), 5)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x, noise = mae_training.batch_rows(_dp_data()[1], cfg.patch_size, gen, mesh, dev)
    _reset_counts()  # just before the data-parallel step
    loss = steps.mae_train_step(model, opt, x, torch.bfloat16, "kernel", noise, gen, mesh)
    torch.cuda.synchronize()
    counts = _all_counts()
    if noise is None:  # one device: the step's own draw (models/mae_train_fused.py), again
        L = (x.shape[1] // cfg.patch_size) * (x.shape[2] // cfg.patch_size)
        noise = vit_mae.masking_noise(x.shape[0], L, torch.Generator(device=dev).manual_seed(SEED),
                                      dev)
    _, mask, _ = vit_mae.random_masking(noise[..., None], noise, cfg.mask_ratio)
    return (float(loss), {q: w.grad.detach().cpu() for q, w in model.named_parameters()},
            torch.cat(gather_objects(mask.cpu(), mesh)), counts)


def _dp_extract(mesh, dev):
    """operaCT features of phase 31's clips (one batch of DP_CLIPS) and the
    extraction's launch counts."""
    from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor

    ex = FeatureExtractor("operaCT", dim=768, batch_size=DP_CLIPS, random_init=True, seed=SEED,
                          mesh=mesh, device=dev)
    wavs = _dp_data()[2]
    _reset_counts()  # just before the extraction
    feats = ex.extract_waveforms(wavs, max_len=160000)
    return feats, _all_counts()


def _dp_nccl_rank(mesh):
    return _dp_cola(mesh, mesh.device, time_it=True)


def _dp_gloo_rank(mesh):
    """Phase 31's two-rank work on one rank; rank 0 returns it with every
    rank's launch counts."""
    from heart_murmur_detection_tpu_torch.parallel.mesh import gather_objects

    cola = _dp_cola(mesh, mesh.device, time_it=True)
    mae = _dp_mae(mesh, mesh.device)
    zero = _dp_cola(mesh, mesh.device, "plain", zero=True)
    plain = _dp_cola(mesh, mesh.device, "plain")  # the same ranks without ZeRO-3
    feats = _dp_extract(mesh, mesh.device)
    counts = gather_objects({"cola": cola[2], "mae": mae[3], "extract": feats[1]}, mesh)
    return {"cola": cola, "mae": mae, "zero": zero, "plain": plain, "extract": feats,
            "counts": counts}


def _dp_cli_rank(mesh, method, kw):
    """cli.pretrain's rank function with its launch counts read around it."""
    from heart_murmur_detection_tpu_torch.cli import pretrain
    from heart_murmur_detection_tpu_torch.parallel.mesh import gather_objects

    _reset_counts()  # just before the rank's epoch
    out = pretrain.train(mesh, method, kw)
    return out, gather_objects(_all_counts(), mesh)


def _dp_compare(tag, got, want, floor, bar, norm_tol, smi, skip=()):
    """Step-0 gradients of a data-parallel run against one device
    (bench/dp_scale.py::grad_report): each leaf's cosine >= floor
    (required), the count under bar and bitwise equality (printed), the
    global norm ratio within 1 +- norm_tol. Leaves named in `skip` (exact
    gradient 0, float noise in every run) are left out of the cosines."""
    from heart_murmur_detection_tpu_torch.bench.dp_scale import grad_report

    r = grad_report(got, want, bar, skip)
    lo, c, ratio = r["min_leaf"], r["min_leaf_cosine"], r["norm_ratio"]
    print(f"[dp] {tag}, {smi}: step-0 gradients over {r['leaves']} leaves: min cosine "
          f"{c:.7f} ({lo}) (floor {floor}), {r[f'leaves_under_{bar}']} leaves under {bar}, "
          f"global norm ratio {ratio:.7f} (bar 1 +- {norm_tol}), bitwise equal: {r['bitwise']}",
          flush=True)
    _require(c >= floor, f"{tag}: step-0 gradient {lo} cosine {c} < {floor}")
    _require(abs(ratio - 1) <= norm_tol, f"{tag}: gradient norm ratio {ratio}")


def _dp_counts_ok(tag, counts: dict, per_step: dict, fwd: int, steps: int):
    ok = all(counts[q] == v * steps for q, v in per_step.items())
    ok &= counts["swin_attn"] == counts["swin_mlp"] == fwd
    _require(ok, f"{tag}: launch counts {counts} for {steps} steps (want {per_step} a step and "
                 f"{fwd} of each forward kernel)")


def phase_dp(smi: str, dev):
    """Phase 31: data parallelism on the card (see the module doc)."""
    import math

    import numpy as np
    import torch

    from heart_murmur_detection_tpu_torch.cli import pretrain
    from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig
    from heart_murmur_detection_tpu_torch.models.vit_mae import audiomae_base_config
    from heart_murmur_detection_tpu_torch.parallel import launch

    t_phase = time.time()
    cola_per_step = {"swin_attn_bwd": 20, "swin_mlp_bwd": 20, "swin_wgrad": 80,
                     "swin_reduce": _reduce_per_step(HTSATConfig())}
    mae_per_step = _mae_per_step(audiomae_base_config())
    # the one-device references, in this process
    l1, g1, c1, ms1 = _dp_cola(None, dev, time_it=True)
    _dp_counts_ok("[dp] one device", c1, cola_per_step, 20 * DP_STEPS, DP_STEPS)
    lm1, gm1, mask1, _ = _dp_mae(None, dev)
    lz1, gz1 = _dp_cola(None, dev, "plain")[:2]
    f1 = _dp_extract(None, dev)[0]
    torch.cuda.empty_cache()
    print(f"[dp] one device, {smi}: COLA losses {l1}, step {ms1:.2f} ms (B={B_TRAIN} x 251, "
          f"train kernels); Audio-MAE loss {lm1:.6f}; plain bf16 COLA losses {lz1}",
          flush=True)

    t0 = time.time()
    ln, gn, cn, msn = launch(_dp_nccl_rank, 1, backend="nccl", device="cuda")
    rel = max(abs(a - b) / abs(b) for a, b in zip(ln, l1))
    print(f"[dp] NCCL world 1, {smi}: COLA losses {ln} against {l1} without a mesh, max rel "
          f"diff {rel:.3g} (bar 1e-4); step {msn:.2f} ms against {ms1:.2f} ms; launches {cn}; "
          f"{time.time() - t0:.1f} s with the child's start", flush=True)
    _require(rel <= 1e-4, f"NCCL world-1 COLA losses {ln} vs {l1}")
    _dp_counts_ok("[dp] NCCL world 1", cn, cola_per_step, 20 * DP_STEPS, DP_STEPS)
    _dp_compare("NCCL world 1 vs no mesh", gn, g1, GRAD_FLOOR, SAME_ROUNDING_BAR, 1e-3, smi)
    del gn

    t0 = time.time()
    out = launch(_dp_gloo_rank, 2, backend="gloo", device="cuda")
    lg, gg, _, msg = out["cola"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lg, l1))
    print(f"[dp] gloo world 2 on cuda:0 ({DP_NOTE}), {smi}: COLA losses {lg} against {l1}, max "
          f"rel diff {rel:.3g} (bar {LOSS_RTOL}); step {msg:.2f} ms a rank at {B_TRAIN // 2} "
          f"rows against {ms1:.2f} ms on one device at {B_TRAIN}; {time.time() - t0:.1f} s with "
          f"the children's start", flush=True)
    _require(rel <= LOSS_RTOL, f"gloo world-2 COLA losses {lg} vs {l1}")
    _dp_compare("gloo world 2 COLA vs one device", gg, g1, GRAD_FLOOR, GRAD_BAR, 1e-2, smi)
    del gg, g1
    lm, gm, mask, _ = out["mae"]
    relm = abs(lm - lm1) / abs(lm1)
    print(f"[dp] gloo world 2 Audio-MAE step (K9), {smi}: loss {lm:.6f} against {lm1:.6f}, rel "
          f"diff {relm:.3g} (bar {LOSS_RTOL}); both ranks' masks (from their rows of the global "
          f"noise) = the one-device masks: {torch.equal(mask, mask1)}", flush=True)
    _require(relm <= LOSS_RTOL, f"Audio-MAE world-2 loss {lm} vs {lm1}")
    _require(torch.equal(mask, mask1), "Audio-MAE masks differ")
    _dp_compare("gloo world 2 Audio-MAE vs one device", gm, gm1, GRAD_FLOOR, GRAD_BAR, 1e-2, smi,
                skip=ZERO_GRAD)
    del gm, gm1
    lz, gz = out["zero"][:2]
    lp, gp = out["plain"][:2]
    relz = abs(lz[0] - lz1[0]) / abs(lz1[0])
    relp = max(abs(a - b) / abs(b) for a, b in zip(lz, lp))
    print(f"[dp] gloo world 2 ZeRO-3 COLA, {DP_STEPS} steps, plain bf16 path, {smi}: losses {lz}; "
          f"step 0 against one device {lz1[0]:.6f}, rel diff {relz:.3g} (bar {LOSS_RTOL}; step 1 "
          f"one device {lz1[1]:.6f}, information: Adam's first update is lr * sign(g), so bf16 "
          f"noise in small gradients moves it); against plain DP on the same ranks {lp}, max rel "
          f"diff {relp:.3g} (bar 1e-5: step 1 follows the sharded Adam update), bitwise equal: "
          f"{lz == lp}", flush=True)
    _require(relz <= LOSS_RTOL, f"ZeRO-3 COLA loss {lz[0]} vs {lz1[0]}")
    _require(relp <= 1e-5, f"ZeRO-3 COLA losses {lz} vs plain DP {lp}")
    _dp_compare("gloo world 2 ZeRO-3 COLA (reduce-scattered) vs one device, plain bf16", gz, gz1,
                GRAD_FLOOR, GRAD_BAR, 1e-2, smi)
    _dp_compare("gloo world 2 ZeRO-3 COLA vs plain DP on the same ranks", gz, gp,
                SAME_ROUNDING_BAR, SAME_ROUNDING_BAR, 1e-5, smi)
    del gz, gz1, gp
    feats = out["extract"][0]
    cos = [_cos(a, b) for a, b in zip(feats, f1)]
    print(f"[dp] gloo world 2 operaCT extraction of {DP_CLIPS} 10-s clips (K1-K3, "
          f"{DP_CLIPS // 2} rows a rank), {smi}: per-clip cosine against one device min "
          f"{min(cos):.7f} (bar {SAME_ROUNDING_BAR})", flush=True)
    _require(feats.shape == f1.shape and min(cos) >= SAME_ROUNDING_BAR,
             f"extraction at world 2: cosines {cos}")
    for r, c in enumerate(out["counts"]):
        _dp_counts_ok(f"[dp] rank {r} COLA", c["cola"], cola_per_step, 20 * DP_STEPS, DP_STEPS)
        ok = all(c["mae"][q] == v for q, v in mae_per_step.items())
        _require(ok, f"rank {r} Audio-MAE launches {c['mae']} (want {mae_per_step})")
        _require(c["extract"]["swin_attn"] == c["extract"]["swin_mlp"] == 12,
                 f"rank {r} extraction launches {c['extract']}")
    print(f"[dp] launches a rank: {out['counts']}", flush=True)

    with tempfile.TemporaryDirectory() as root:
        _write_corpora(root)
        cwd = os.getcwd()
        os.chdir(root)
        real = pretrain.launch
        pretrain.launch = lambda fn, n, *a, **kw: real(_dp_cli_rank, n, *a, **kw)
        try:
            t0 = time.time()
            (((_, hist, _), counts),) = pretrain.main([
                "dp=2", "dist_backend=gloo", "method=cola", "encoder=htsat",
                "compute_dtype=bfloat16", f"batch_size={DP_CLI_BATCH}", "epoches=1", "seed=0",
                "title=dp",
                "device=cuda", *(f"{c}=True" for c in CP_CORPORA)])
            wall = time.time() - t0
        finally:
            pretrain.launch = real
            os.chdir(cwd)
    h = hist[0]
    n_val = len(CP_CORPORA)  # one validation batch of the 30 clips a corpus (drop_last)
    for r, c in enumerate(counts):
        _dp_counts_ok(f"[dp] cli.pretrain rank {r}", c, cola_per_step,
                      20 * h["steps"] + 24 * n_val, h["steps"])
    _require(all(math.isfinite(h[q]) for q in ("train_loss", "valid_loss")), f"losses {h}")
    print(f"[dp] cli.pretrain dp=2 dist_backend=gloo method=cola encoder=htsat bf16, "
          f"B={DP_CLI_BATCH} ({DP_CLI_BATCH // 2} a rank), {DP_NOTE}, {smi}: {h['steps']} steps "
          f"in {h['train_seconds']:.2f} s = "
          f"{h['train_seconds'] / h['steps'] * 1e3:.1f} ms a step (first included); train loss "
          f"{h['train_loss']:.4f} valid {h['valid_loss']:.4f}; {wall:.1f} s with the ranks' start; "
          f"launches a rank {counts}", flush=True)
    print(f"[dp] phase 31 took {time.time() - t_phase:.1f} s", flush=True)

# ---------------------------------------------------------------------------
# phase 32: the tensor axis (dp x tp, parallel/tensor.py) on plain torch
# ---------------------------------------------------------------------------

TP_B = 8  # phase 32's global batch: 4 rows a data rank at dp2 x tp2
TP_STEPS = 2  # its COLA steps
TP_NOTE = "four gloo ranks (dp2 x tp2) share one H100, collectives staged through the host; " \
          "not a multi-card figure"
TP_LOSS_RTOL = 1e-5  # float32, TF32 off: the step-0 loss against one device
TP_LEAF_BAR = 0.99999  # float32: every step-0 gradient leaf's cosine
TP_NORM_TOL = 1e-4  # float32: the global gradient norm's ratio
# bf16 plain route, at phase 31's shape (B_TRAIN, 32 rows a data rank): the
# step-0 loss (the leaves at GRAD_FLOOR). At TP_B the bf16 flow's own
# batch-split spread is past these floors: on the CPU, plain DP at 4 rows a
# rank read 3.6e-3 of the loss and a 0.99881 leaf from one device (PERF.md)
TP_BF16_LOSS_RTOL = 5e-4
TP_CLI_CLIPS = 24  # phase 32's cli.pretrain corpus: circor clips of phase 8's writer
# 1 step an epoch (the 10% validation split is under one batch: no valid
# loss); 5 epochs write the resume checkpoint, a 6th reloads it
TP_CLI_BATCH = 16


def _tp_data():
    """Phase 32's inputs, made alike in every process: TP_STEPS COLA pairs
    at phase 8's circor crop (TP_B x 251 x 64), an Audio-MAE batch (TP_B x
    1024 x 128), a fine-tuning batch (TP_B x 256 x 64, two classes) and a
    COLA pair at phase 31's shape (B_TRAIN x 251 x 64)."""
    import numpy as np

    r = np.random.default_rng(SEED + 50)
    mel = lambda T, B=TP_B: (r.standard_normal((B, T, 64)) * 10 - 40).astype(np.float32)
    cola = [(mel(251), mel(251)) for _ in range(TP_STEPS)]
    mae = r.standard_normal((TP_B, 1024, 128)).astype(np.float32)
    ft = mel(256), (np.arange(TP_B) % 2).astype(np.int64)
    return cola, mae, *ft, (mel(251, B_TRAIN), mel(251, B_TRAIN))


def _tp_cola(mesh, dev, mm, impl, megatron=False, zero=False, n_steps=TP_STEPS, time_it=False,
             wide=False):
    """n_steps of the trainer's COLA step on the full-width operaCT
    (bench/dp_scale.py::cola_steps, DropPath and dropout off) on this
    rank's rows of TP_B pairs (wide: one step of B_TRAIN): (losses, step-0
    summed gradients on the host, the rank's parameter shapes and SHA-1s
    after the steps, ms a step or None)."""
    import hashlib

    import torch

    from heart_murmur_detection_tpu_torch.bench import dp_scale
    from heart_murmur_detection_tpu_torch.pretrain import cola_training as ct

    data = _tp_data()
    batches = [data[4]] if wide else data[0][:n_steps]
    run = dp_scale.cola_steps(mesh, dev, batches, impl, zero, SEED, mm_dtype=mm,
                              megatron=megatron)
    ms = None
    if time_it:
        x1, x2 = run["batches"][0]
        ms = _time_ms(lambda: ct.train_step(run["model"], run["opt"], x1, x2, None, mm, impl, 0.0,
                                            mesh, run["zero"]), iters=1, warm=0)
    named = list(run["model"].named_parameters())
    shapes = {q: tuple(w.shape) for q, w in named}
    sha = {q: hashlib.sha1(w.detach().float().cpu().numpy().tobytes()).hexdigest()
           for q, w in named}
    return run["losses"], run["grads"], shapes, sha, ms


def _tp_mae(mesh, dev, megatron=False):
    """One Audio-MAE CP step (the ViT-B encoder and the SwinV2-CR decoder at
    full width) of the trainer in float32 (autograd route), the masking
    noise of the global batch drawn from a generator seeded SEED: (loss,
    step-0 summed gradients)."""
    import torch

    from heart_murmur_detection_tpu_torch.bench.dp_scale import summed_grads
    from heart_murmur_detection_tpu_torch.models import vit_mae
    from heart_murmur_detection_tpu_torch.parallel import tensor
    from heart_murmur_detection_tpu_torch.pretrain import mae_training, steps

    cfg = vit_mae.audiomae_base_config(mask_ratio=0.7)
    model = vit_mae.MaskedAutoencoderViT(cfg, decoder=True)
    vit_mae.init_weights(model, torch.Generator().manual_seed(SEED))
    model.to(dev).train()
    if megatron:
        tensor.shard_model(model, mesh)
    opt = steps.adam_with_epoch_decay(list(model.parameters()), 5)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x, noise = mae_training.batch_rows(_tp_data()[1], cfg.patch_size, gen, mesh, dev)
    loss = steps.mae_train_step(model, opt, x, torch.float32, "autograd", noise, gen, mesh)
    return float(loss), summed_grads(list(model.named_parameters()))


def _tp_ft(mesh, dev, megatron=False):
    """One operaCT fine-tuning step of the trainer (finetune.train_step,
    linear head, ClippedAdam) in float32 on the global batch, DropPath off:
    (loss, summed gradients)."""
    import torch

    from heart_murmur_detection_tpu_torch.bench.dp_scale import summed_grads
    from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig
    from heart_murmur_detection_tpu_torch.parallel import tensor
    from heart_murmur_detection_tpu_torch.train import finetune as ft
    from heart_murmur_detection_tpu_torch.train.linear_eval import ClippedAdam

    cfg = HTSATConfig(drop_path_rate=0.0)
    model = ft.EncoderClassifier("htsat", 2, "linear", cfg.num_features, cfg,
                                 generator=torch.Generator().manual_seed(SEED)).to(dev).train()
    if megatron:
        tensor.shard_model(model, mesh)
    named = list(model.named_parameters())
    opt = ClippedAdam([w for _, w in named], 1, 1e-4, 0.99, 1.0, optax_clip=True)
    _, _, x, y, _ = _tp_data()
    xb, yb = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    valid = torch.ones(TP_B, device=dev)
    cw = torch.tensor([0.4, 0.6], device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    loss, grads = ft.train_step(model, opt, xb, yb, valid, cw, gen, torch.float32, "autograd",
                                1e-4, None, mesh, None, gen)
    return float(loss), summed_grads(named, grads=grads)


def _tp_cli(mesh, root: str):
    """cli.pretrain method=cola encoder=htsat dp=2 tp=2 dist_backend=gloo
    (bf16, the plain route) in this rank as torchrun would run it, from
    `root`: 5 epochs of TP_CLI_BATCH (the resume checkpoint of epoch 4),
    then resume=True to 6 (the checkpoint reloaded into the tensor axis):
    (the two histories, the resumed run's state, the launches of both)."""
    from heart_murmur_detection_tpu_torch.cli import pretrain

    cwd = os.getcwd()
    os.chdir(root)
    try:
        argv = ["dp=2", "tp=2", "dist_backend=gloo", "method=cola", "encoder=htsat",
                "compute_dtype=bfloat16", f"batch_size={TP_CLI_BATCH}", "seed=0", "title=tp",
                "device=cuda", "circor=True"]
        _reset_counts()
        ((_, h5, _),) = pretrain.main(argv + ["epoches=5"])
        ((sd, h6, _),) = pretrain.main(argv + ["epoches=6", "resume=True"])
        return h5, h6, {q: v.cpu() for q, v in sd.items()}, _all_counts()
    finally:
        os.chdir(cwd)


def _tp_rank(mesh, root: str):
    """Phase 32's work on one rank of the dp2 x tp2 mesh; rank 0 returns it
    with every rank's shapes, parameter SHA-1s and launch counts."""
    import torch

    from heart_murmur_detection_tpu_torch.parallel.mesh import gather_objects

    dev = mesh.device
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    _reset_counts()  # the tensor axis launches no kernel of the repository
    f32 = _tp_cola(mesh, dev, torch.float32, "autograd", megatron=True, time_it=True)
    bf16 = _tp_cola(mesh, dev, torch.bfloat16, "plain", megatron=True, wide=True)
    fsdp = _tp_cola(mesh, dev, torch.float32, "autograd", zero=True, n_steps=1)
    mae = _tp_mae(mesh, dev, megatron=True)
    fine = _tp_ft(mesh, dev, megatron=True)
    counts = _all_counts()
    torch.cuda.synchronize()
    cli = _tp_cli(mesh, root)
    ranks = gather_objects({"shapes": f32[2], "sha": f32[3], "counts": counts,
                            "cli_counts": cli[3]}, mesh)
    return {"f32": f32[:2] + (f32[4],), "bf16": bf16[:2], "fsdp": fsdp[:2],
            "mae": mae, "ft": fine, "cli": cli[:3], "ranks": ranks}


def _without_key_bias(grads: dict) -> dict:
    """The gradients with the key third of each qkv bias left out: its
    exact gradient is 0 (it adds a per-query constant to the logits), so
    it holds float noise only (tests/test_torch_parallel_cola.py treats it
    so); the q and v thirds stay."""
    import torch

    out = dict(grads)
    for q, g in grads.items():
        if q.endswith("attn.qkv.bias"):
            n = g.shape[0] // 3
            out[q] = torch.cat([g[:n], g[2 * n:]])
    return out


def _tp_compare(tag, got, want, rtol, floor, norm_tol, smi, skip=(), drop_key_bias=False):
    """The step-0 loss and every gradient leaf of a tensor-parallel step
    against one device (bench/dp_scale.py::grad_report). got, want: (loss
    or the steps' losses, step-0 summed gradients, ...). drop_key_bias: the
    key thirds of the qkv biases left out of the cosines (bf16, where their
    float noise is rounded: _without_key_bias)."""
    from heart_murmur_detection_tpu_torch.bench.dp_scale import grad_report

    step0 = lambda v: v[0][0] if isinstance(v[0], list) else v[0]
    lg, lw = step0(got), step0(want)
    rel = abs(lg - lw) / abs(lw)
    pick = _without_key_bias if drop_key_bias else (lambda g: g)
    r = grad_report(pick(got[1]), pick(want[1]), floor, skip)
    lo, c, ratio = r["min_leaf"], r["min_leaf_cosine"], r["norm_ratio"]
    print(f"[tp] {tag}, {smi}: step-0 loss {lg:.7f} against {lw:.7f} one device, rel "
          f"diff {rel:.3g} (bar {rtol}); {r['leaves']} gradient leaves, min cosine {c:.7f} "
          f"({lo}) (floor {floor}), global norm ratio {ratio:.7f} (bar 1 +- {norm_tol})",
          flush=True)
    _require(rel <= rtol, f"{tag}: step-0 loss {lg} vs {lw}")
    _require(c >= floor, f"{tag}: gradient leaf {lo} cosine {c} < {floor}")
    _require(abs(ratio - 1) <= norm_tol, f"{tag}: gradient norm ratio {ratio}")


def _write_tp_corpus(root: str):
    """TP_CLI_CLIPS circor clips of phase 8's writer (_write_corpora's
    layout, clip lengths and value range)."""
    import numpy as np

    r = np.random.default_rng(SEED + 4)
    d = os.path.join(root, "feature", "circor_eval")
    os.makedirs(os.path.join(d, "spec"))
    names = []
    for i, t in enumerate(r.integers(260, 1001, TP_CLI_CLIPS)):
        f = os.path.join("feature", "circor_eval", "spec", f"{i:03d}")
        np.save(os.path.join(root, f + ".npy"),
                (r.standard_normal((int(t), 64)) * 10 - 40).astype(np.float32))
        names.append(f)
    np.save(os.path.join(d, "entire_spec_filenames.npy"), np.asarray(names))


def phase_tp(smi: str, dev):
    """Phase 32: the tensor axis on the card (see the module doc)."""
    import concurrent.futures
    import math

    import torch

    from heart_murmur_detection_tpu_torch.models.cola import Cola
    from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig
    from heart_murmur_detection_tpu_torch.parallel import launch
    from heart_murmur_detection_tpu_torch.train.checkpoints import load_state

    t_phase = time.time()
    with tempfile.TemporaryDirectory() as root, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        _write_tp_corpus(root)
        t0 = time.time()
        ranks = pool.submit(launch, _tp_rank, 4, root, backend="gloo", device="cuda", tp=2)
        # the one-device references, in this process while the ranks start and work
        # (their step times are taken after the ranks end)
        f32_1 = _tp_cola(None, dev, torch.float32, "autograd")
        bf16_1 = _tp_cola(None, dev, torch.bfloat16, "plain", wide=True)
        mae_1 = _tp_mae(None, dev)
        ft_1 = _tp_ft(None, dev)
        out = ranks.result()
        wall = time.time() - t0
        ck = load_state(os.path.join(root, "cks", "model", "combined", "circor", "tp",
                                     "last.ckpt"))
    ms_f32 = _tp_cola(None, dev, torch.float32, "autograd", n_steps=1, time_it=True)[4]
    ms_bf16 = _tp_cola(None, dev, torch.bfloat16, "plain", time_it=True, wide=True)[4]
    torch.cuda.empty_cache()
    print(f"[tp] dp2 x tp2 ({TP_NOTE}), {smi}: the ranks' work took {wall:.1f} s with their "
          f"start (the one-device references ran alongside)", flush=True)
    _tp_compare("megatron COLA, operaCT full width, float32 (TF32 off)", out["f32"], f32_1,
                TP_LOSS_RTOL, TP_LEAF_BAR, TP_NORM_TOL, smi)
    _tp_compare(f"megatron COLA, bf16 plain route, phase 31's B={B_TRAIN}", out["bf16"], bf16_1,
                TP_BF16_LOSS_RTOL, GRAD_FLOOR, 1e-2, smi, drop_key_bias=True)
    _tp_compare("fsdp over the model axis, COLA, float32", out["fsdp"], f32_1, TP_LOSS_RTOL,
                TP_LEAF_BAR, TP_NORM_TOL, smi)
    _tp_compare("megatron Audio-MAE CP (ViT-B + SwinV2-CR decoder), float32", out["mae"], mae_1,
                TP_LOSS_RTOL, TP_LEAF_BAR, TP_NORM_TOL, smi, skip=ZERO_GRAD)
    _tp_compare("megatron operaCT fine-tuning, float32", out["ft"], ft_1, TP_LOSS_RTOL,
                TP_LEAF_BAR, TP_NORM_TOL, smi)
    ranks = out["ranks"]
    full = dict(f32_1[2])
    qkv = "encoder.encoder.htsat.layers.0.blocks.0.attn.qkv.weight"
    for r, rk in enumerate(ranks):
        C = full[qkv][1]
        _require(rk["shapes"][qkv] == (3 * C // 2, C), f"rank {r} qkv {rk['shapes'][qkv]}")
        _require(not any(rk["counts"].values()) and not any(rk["cli_counts"].values()),
                 f"rank {r} launched kernels on the tensor axis: {rk['counts']}")
    sharded = {q for q, s in ranks[0]["shapes"].items() if s != full[q]}
    peers = [(0, 1), (2, 3)]
    same = all(ranks[a]["sha"][q] == ranks[b]["sha"][q]
               for a, b in peers for q in full if q not in sharded)
    across = all(ranks[a]["sha"][q] == ranks[a + 2]["sha"][q] for a in (0, 1) for q in full)
    print(f"[tp] after {TP_STEPS} float32 steps: {len(full) - len(sharded)} replicated leaves "
          f"bit for bit equal on the model peers: {same}; every leaf equal across the data "
          f"axis: {across}; {len(sharded)} leaves sharded (stage 0's qkv {ranks[0]['shapes'][qkv]} "
          f"of {full[qkv]} on each model rank); no kernel launched on any rank", flush=True)
    _require(same and across, "replicated parameters differ across the ranks")
    print(f"[tp] ms a step a rank ({TP_NOTE}), {smi}: COLA float32 at B={TP_B} ({TP_B // 2} rows "
          f"a data rank) {out['f32'][2]:.1f} ms (one device {ms_f32:.1f} ms at {TP_B}); bf16 "
          f"plain route, one device at B={B_TRAIN} {ms_bf16:.1f} ms; the CLI's bf16 steps below",
          flush=True)
    h5, h6, sd = out["cli"]
    model = Cola(HTSATConfig(), encoder="htsat")
    model.load_state_dict(ck["state_dict"])  # the checkpoint's full tensors, by name
    model.load_state_dict(sd)
    moments = ck["optimizer"]["adam"]["state"]
    shapes_ok = all(moments[i]["exp_avg"].shape == w.shape
                    for i, w in enumerate(model.parameters()))
    _require([e["epoch"] for e in h5] == list(range(5)) and [e["epoch"] for e in h6] == [5],
             f"epochs {[e['epoch'] for e in h5]}, resumed {[e['epoch'] for e in h6]}")
    _require(ck["epoch"] == 4 and shapes_ok, "the resume checkpoint's epoch or moments")
    _require(all(math.isfinite(e["train_loss"]) for e in h5 + h6), f"losses {h5} {h6}")
    steps = sum(e["steps"] for e in h5)
    print(f"[tp] cli.pretrain dp=2 tp=2 dist_backend=gloo method=cola encoder=htsat bf16, "
          f"B={TP_CLI_BATCH}, {TP_CLI_CLIPS} clips, {smi}: 5 epochs "
          f"({steps} steps, {sum(e['train_seconds'] for e in h5) / steps * 1e3:.1f} ms a step, "
          f"first included), the resume checkpoint of epoch 4 (full tensors and Adam moments) "
          f"loads into a one-device Cola by name, resume=True ran epoch 5 from it (train loss "
          f"{h6[0]['train_loss']:.4f})", flush=True)
    print(f"[tp] phase 32 took {time.time() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 34: megatron fine-tuning of every encoder kind (parallel/tensor.py)
# ---------------------------------------------------------------------------

ZOO_TP_ROWS = 4  # rows a data rank a step
ZOO_TP_STEPS = 3  # fine-tuning steps: one epoch of ZOO_TP_STEPS batches
ZOO_TP_VAL = 8  # validation clips (one padded predict batch of 64)
# (encoder kind, model ranks, what the tensor axis splits): CLAP 2022 / 2023
# and HeAR at dp2 x tp2, operaGT's ViT-S (6 heads) at dp1 x tp4, the head split
ZOO_TP_KINDS = (
    ("clap", 2, "the full Cnn14 on 5-s clips at 44.1 kHz, fc1 column-parallel"),
    ("clap2023", 2, "the CLAP HTS-AT, C 96-768, heads 4/8/16/32, on 7-s clips at 44.1 kHz"),
    ("hear", 2, "the ViT-L/16, C 1024, 16 heads, 24 blocks, on 2-s clips"),
    ("gt", 4, "operaGT's ViT-S, C 384, 6 heads over 4 model ranks: the head split"),
)
ZOO_TP_NOTE = "four gloo ranks share one H100, collectives staged through the host; " \
              "not a multi-card figure"


@contextlib.contextmanager
def _no_draws():
    """The CLAP projection's dropout and the CLAP HTS-AT's DropPath off
    where the classifier builds them (the ranks draw from generators of
    their data index, one device from its own), as phase 32 runs."""
    from heart_murmur_detection_tpu_torch.models import clap

    cfg, htsat = clap.CLAPConfig, clap.HTSATConfig
    clap.CLAPConfig = lambda **kw: cfg(**{**kw, "proj_dropout": 0.0})
    clap.HTSATConfig = lambda **kw: htsat(**{**kw, "drop_path_rate": 0.0})
    try:
        yield
    finally:
        clap.CLAPConfig, clap.HTSATConfig = cfg, htsat


def _zoo_tp_data(kind: str, n_data: int):
    """Phase 34's clips of a kind, made alike in every process:
    ZOO_TP_STEPS batches of ZOO_TP_ROWS rows a data rank, then ZOO_TP_VAL
    validation clips; two classes, class 1 with a 440 Hz tone (waveforms)
    or 3 dB up (operaGT's 256 x 64 mels)."""
    import numpy as np

    from heart_murmur_detection_tpu_torch.models.clap import CLAPConfig

    r = np.random.default_rng(SEED + 60)
    n = ZOO_TP_ROWS * n_data * ZOO_TP_STEPS + ZOO_TP_VAL
    y = (np.arange(n) % 2).astype(np.int64)
    if kind == "gt":
        return (r.standard_normal((n, 256, 64)) * 10 - 40 + 3 * y[:, None, None]).astype(
            np.float32), y
    cfg = CLAPConfig(version="2023" if kind == "clap2023" else "2022")
    sr, m = (16000, 32000) if kind == "hear" else (cfg.sample_rate, cfg.n_samples)
    tone = np.sin(2 * np.pi * 440 * np.arange(m) / sr).astype(np.float32)
    x = 0.05 * r.standard_normal((n, m), dtype=np.float32) + 0.2 * y[:, None] * tone
    return x.astype(np.float32), y


def _zoo_tp_run(mesh, kind: str, n_data: int, dev):
    """finetune_classifier of `kind` in float32 on this rank's mesh under
    megatron (mesh None: one device), one epoch of ZOO_TP_STEPS steps, the
    trainer's train_step wrapped to record each step's loss and ms, step
    0's summed gradients and the rank's parameter shapes: (losses, step-0
    gradients, shapes, ms a step, valid AUROC, SHA-1 of each leaf of the
    state it returns)."""
    import hashlib

    import torch

    from heart_murmur_detection_tpu_torch.bench.dp_scale import summed_grads
    from heart_murmur_detection_tpu_torch.train import finetune as ft

    x, y = _zoo_tp_data(kind, n_data)
    n_train = len(x) - ZOO_TP_VAL
    rec = {"losses": [], "ms": [], "grads": None, "shapes": None}
    real = ft.train_step

    def step(model, opt, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = real(model, opt, *args, **kw)
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["losses"].append(float(loss))
        if rec["grads"] is None:
            names = {id(w): q for q, w in model.named_parameters()}
            rec["grads"] = summed_grads([(names[id(w)], w) for w in opt.params], grads=grads)
            rec["shapes"] = {q: tuple(w.shape) for q, w in model.named_parameters()}
        return loss, grads

    ft.train_step = step
    try:
        with _no_draws():
            res = ft.finetune_classifier(
                x[:n_train], y[:n_train], x[n_train:], y[n_train:], encoder_kind=kind, n_cls=2,
                feat_dim=384 if kind == "gt" else 1024, epochs=1,
                batch_size=ZOO_TP_ROWS * n_data, seed=SEED, mesh=mesh,
                param_sharding=None if mesh is None else "megatron", device=dev)
    finally:
        ft.train_step = real
    sha = {q: hashlib.sha1(v.float().numpy().tobytes()).hexdigest()
           for q, v in res.state_dict.items()}
    return rec["losses"], rec["grads"], rec["shapes"], rec["ms"], res.valid_auc, sha


def _zoo_tp_rank(mesh):
    """Phase 34's work on one rank: the dp2 x tp2 kinds on the launch's
    mesh, operaGT on a dp1 x tp4 mesh over the same four ranks; rank 0
    returns the runs with every rank's shapes, SHA-1s and launch counts."""
    import torch

    from heart_murmur_detection_tpu_torch.parallel.mesh import gather_objects, mesh_2d

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    _reset_counts()  # the tensor axis launches no kernel of the repository
    wide = mesh_2d(1, 4, mesh.backend, mesh.device)
    runs, mine = {}, {}
    for kind, tp, _ in ZOO_TP_KINDS:
        m = mesh if tp == mesh.n_model else wide
        losses, grads, shapes, ms, auc, sha = _zoo_tp_run(m, kind, m.n_data, mesh.device)
        if mesh.rank == 0:
            runs[kind] = (losses, grads, ms, auc)
        mine[kind] = {"shapes": shapes, "sha": sha}
        del grads
        torch.cuda.empty_cache()
    mine["counts"] = _all_counts()
    return {"runs": runs, "ranks": gather_objects(mine, mesh)}


def phase_zoo_tp(smi: str, dev):
    """Phase 34: megatron fine-tuning of every encoder kind on the tensor
    axis (see the module doc)."""
    import concurrent.futures
    import statistics

    import torch

    from heart_murmur_detection_tpu_torch.parallel import launch

    t_phase = time.time()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        t0 = time.time()
        ranks = pool.submit(launch, _zoo_tp_rank, 4, backend="gloo", device="cuda", tp=2)
        # the one-device references, in this process while the ranks start and work
        one = {kind: _zoo_tp_run(None, kind, 4 // tp, dev) for kind, tp, _ in ZOO_TP_KINDS}
        out = ranks.result()
        wall = time.time() - t0
    torch.cuda.empty_cache()
    print(f"[zoo tp] ({ZOO_TP_NOTE}), {smi}: the ranks' work took {wall:.1f} s with their start "
          f"(the one-device references ran alongside)", flush=True)
    ranks = out["ranks"]
    for kind, tp, what in ZOO_TP_KINDS:
        losses, grads, ms, auc = out["runs"][kind]
        l1, g1, full, ms1, auc1, _ = one[kind]
        n_data = 4 // tp
        tag = f"megatron {kind} fine-tuning ({what}), dp{n_data} x tp{tp}, float32 (TF32 off)"
        _tp_compare(tag, (losses, grads), (l1, g1), TP_LOSS_RTOL, TP_LEAF_BAR, TP_NORM_TOL, smi)
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, l1)]
        _require(len(losses) == len(l1) == ZOO_TP_STEPS, f"{kind}: steps {len(losses)}")
        col = [q for q in full if q.endswith(("qkv.weight", "fc1.weight"))
               and not q.startswith("head.")]
        peers = [list(range(d * tp, (d + 1) * tp)) for d in range(n_data)]
        for r, rk in enumerate(ranks):
            sh = rk[kind]["shapes"]
            bad = [q for q in col if sh[q] != (full[q][0] // tp, full[q][1])]
            _require(col and not bad, f"rank {r} {kind}: column layers {bad[:3]} not 1/{tp}")
            _require(not any(rk["counts"].values()),
                     f"rank {r} launched kernels on the tensor axis: {rk['counts']}")
        whole = [q for q in full if ranks[0][kind]["shapes"][q] == full[q]]
        apart = sorted({q for g in peers for a in g for q in whole
                        if ranks[a][kind]["sha"][q] != ranks[g[0]][kind]["sha"][q]})
        across = all(ranks[r][kind]["sha"] == ranks[0][kind]["sha"] for r in range(4))
        _require(not apart and across, f"{kind}: the ranks' states differ after the steps "
                 f"(replicated leaves apart on model peers: {apart[:4]} of {len(apart)})")
        med = statistics.median(ms[1:])
        print(f"[zoo tp] {kind}: losses of the {ZOO_TP_STEPS} steps "
              f"{', '.join(f'{v:.7f}' for v in losses)} against one device "
              f"{', '.join(f'{v:.7f}' for v in l1)} (rel diff {', '.join(f'{v:.3g}' for v in rel)}"
              f"); valid AUROC {auc:.4f} against {auc1:.4f}; {len(col)} column-parallel layers "
              f"at 1/{tp} of their rows on every rank ({col[0]} {ranks[0][kind]['shapes'][col[0]]}"
              f" of {full[col[0]]}); {len(whole)} replicated leaves bit for bit equal on the model "
              f"peers, every leaf across the ranks: {across}; no kernel launched; {med:.1f} ms a "
              f"step a rank ({ZOO_TP_NOTE}; {smi}; one device {statistics.median(ms1[1:]):.1f} ms "
              f"at B={ZOO_TP_ROWS * n_data})", flush=True)
    print(f"[zoo tp] phase 34 took {time.time() - t_phase:.1f} s", flush=True)


# Phase 33: the analysis paths at full width
SAL_B, SAL_FRAMES = 8, 251  # saliency: 8 clips of 8 s
LONG_B, LONG_FRAMES = 4, 3751  # long-clip inference: 4 clips of 120 s, 6 crops each
RECON_B = 4  # reconstruction: clips a tower
TRACE_CHILD = """
import sys, torch
sys.path.insert(0, {root!r})
from heart_murmur_detection_tpu_torch.extract.registry import initialize_pretrained_model
from heart_murmur_detection_tpu_torch.utils.profiling import trace
model = initialize_pretrained_model("operaCT", random_init=True, seed=0).cuda()
mel = torch.rand(16, 251, 64, generator=torch.Generator().manual_seed(0)).cuda()
model.htsat(mel, mm_dtype=torch.bfloat16)
torch.cuda.synchronize()
with trace("smoke", out_dir={out!r}, enabled=True):
    model.htsat(mel, mm_dtype=torch.bfloat16)
"""


def _ratio_rule(k, p, f32) -> tuple:
    """Each clip's (1 - cos(kernel, f32)) / (1 - cos(plain, f32)): (median,
    max, the cosines against f32)."""
    import numpy as np

    ck = [_cos(a, c) for a, c in zip(k, f32)]
    cp = [_cos(b, c) for b, c in zip(p, f32)]
    r = [(1 - a) / max(1 - b, 1e-12) for a, b in zip(ck, cp)]
    return float(np.median(r)), max(r), ck, cp


def _phase_saliency(smi: str, dev):
    """Saliency of an operaCT tower plus a linear head on K8's route."""
    import numpy as np
    import torch

    from heart_murmur_detection_tpu_torch.analysis import saliency as S
    from heart_murmur_detection_tpu_torch.extract.registry import initialize_pretrained_model
    from heart_murmur_detection_tpu_torch.models.heads import Head
    from heart_murmur_detection_tpu_torch.models.htsat_train_fused import htsat_encode_train

    model = initialize_pretrained_model("operaCT", random_init=True, seed=SEED).to(dev)
    head = Head(2, "linear", 768, torch.Generator().manual_seed(SEED + 33)).to(dev)
    g = torch.Generator().manual_seed(SEED + 33)
    mel = torch.rand(SAL_B, SAL_FRAMES, 64, generator=g).to(dev)
    run = lambda impl, dt=torch.bfloat16: S.saliency_for_linear_head(
        S.operact_encoder(model, dt, impl), head, mel)
    _reset_counts()
    sal_k, cls_k = run("kernel")
    counts = _all_counts()
    sal_p, cls_p = run("plain")
    sal_f, cls_f = run("autograd", torch.float32)
    n_blocks = sum(model.htsat.config.depths[:3])  # stages 0-2 on the kernels
    want = {"swin_attn": n_blocks, "swin_mlp": n_blocks, "swin_attn_bwd": n_blocks,
            "swin_mlp_bwd": n_blocks, "swin_wgrad": 0, "swin_reduce": 0}
    print(f"[analysis] saliency launches (B={SAL_B} of {SAL_FRAMES} frames): "
          + ", ".join(f"{k} {counts[k]}" for k in want), flush=True)
    _require(all(counts[k] == n for k, n in want.items()),
             f"saliency launches {counts} != {want}")
    _require(np.array_equal(cls_k, cls_p), f"saliency classes {cls_k} != plain {cls_p}")
    cos = [_cos(a, b) for a, b in zip(sal_k, sal_p)]
    med, worst, ck, cp = _ratio_rule(sal_k, sal_p, sal_f)
    print(f"[analysis] saliency K8 vs plain bf16 per clip: min cos {min(cos):.7f} "
          f"(floor {GRAD_FLOOR}); vs strict f32: kernel {min(ck):.7f}, plain {min(cp):.7f}, "
          f"(1 - cos) ratio median {med:.3f} max {worst:.3f}; classes {cls_k.tolist()} "
          f"(f32 {cls_f.tolist()})", flush=True)
    _require(min(cos) >= GRAD_FLOOR or (med <= F32_RATIO_MEDIAN and worst <= F32_RATIO_LEAF),
             f"saliency: min cos {min(cos)} < {GRAD_FLOOR} and ratio {med} / {worst}")

    # the weight products the frozen weights skip: the same backward with
    # the weights taking gradients, its input gradient bit for bit the same
    enc = model.htsat

    def with_weights():
        x = mel.detach().clone().requires_grad_(True)
        h = htsat_encode_train(enc, x, None, None, mm_dtype=torch.bfloat16, deterministic=True,
                               impl="kernel")[0]
        logits = head(h)
        (gx,) = torch.autograd.grad(logits.gather(1, torch.as_tensor(cls_k, device=dev)[:, None])
                                    .sum(), x)
        return gx

    _reset_counts()
    gx = with_weights()
    wcounts = _all_counts()
    same = np.array_equal(gx.abs().cpu().numpy(), sal_k)
    k_ms = _time_ms(lambda: run("kernel"), iters=5, warm=1)
    w_ms = _time_ms(with_weights, iters=5, warm=1)
    p_ms = _time_ms(lambda: run("plain"), iters=3, warm=1)
    print(f"[analysis] saliency ms a batch of {SAL_B}: K8 {k_ms:.2f}, with the weight gradients "
          f"{w_ms:.2f} (swin_wgrad {wcounts['swin_wgrad']}, swin_reduce "
          f"{wcounts['swin_reduce']} launches; input gradient bitwise the same: {same}), "
          f"plain bf16 {p_ms:.2f} ({smi})", flush=True)
    _require(same, "saliency: the input gradient moved when the weight products were skipped")
    return counts


def _phase_long(smi: str, dev):
    """Long-clip inference and the tscam outputs on K1-K3."""
    import torch

    from heart_murmur_detection_tpu_torch.extract.registry import initialize_pretrained_model
    from heart_murmur_detection_tpu_torch.models.htsat import htsat_forward_long
    from heart_murmur_detection_tpu_torch.models.htsat_fused import htsat_apply_fused

    enc = initialize_pretrained_model("operaCT", random_init=True, seed=SEED).to(dev).htsat
    g = torch.Generator().manual_seed(SEED + 34)
    mel = torch.rand(LONG_B, LONG_FRAMES, 64, generator=g).to(dev)
    bf = torch.bfloat16
    run = lambda impl, bs=B_KERNEL: htsat_forward_long(enc, mel, batch_size=bs, mm_dtype=bf,
                                                       impl=impl)
    _reset_counts()
    out_k = run("kernel")
    counts = _all_counts()
    n_crops = len(range(0, LONG_FRAMES - 1024 - 1, 512))
    chunks = -(-n_crops * LONG_B // B_KERNEL)
    n_fwd = sum(enc.config.depths)
    print(f"[analysis] long-clip launches ({LONG_B} clips of {LONG_FRAMES} frames, {n_crops} "
          f"crops each, {chunks} batches of <= {B_KERNEL}): swin_attn {counts['swin_attn']}, "
          f"swin_mlp {counts['swin_mlp']}", flush=True)
    _require(counts["swin_attn"] == counts["swin_mlp"] == chunks * n_fwd,
             f"long-clip launches {counts} != {chunks * n_fwd} each")
    out_p = run("plain")
    cos = {k: min(_cos(a.cpu(), b.cpu()) for a, b in zip(out_k[k], out_p[k]))
           for k in ("latent_output", "clipwise_logits", "framewise_output")}
    # per-crop forwards of the clips (each a batch of LONG_B rows), averaged;
    # the long path at LONG_B rows a batch runs the same launches
    starts = range(0, LONG_FRAMES - 1024 - 1, 512)
    crops = [htsat_apply_fused(enc, mel[:, s : s + 1024].contiguous(), mm_dtype=bf, tscam=True)
             for s in starts]
    mean = {k: torch.stack([c[k] for c in crops]).mean(0) for k in out_k}
    out_b = run("kernel", LONG_B)
    d_mean = max(float((out_b[k] - mean[k]).abs().max()) for k in out_k)
    d_rows = max(float((out_k[k] - out_b[k]).abs().max()) for k in out_k)
    shapes = {k: tuple(v.shape) for k, v in out_k.items()}
    finite = all(bool(torch.isfinite(v).all()) for v in out_k.values())
    k_ms = _time_ms(lambda: run("kernel"), iters=3, warm=1)
    p_ms = _time_ms(lambda: run("plain"), iters=2, warm=1)
    print(f"[analysis] long-clip outputs {shapes}, finite {finite}; kernel vs plain bf16 min "
          f"cos a clip: " + ", ".join(f"{k} {v:.7f}" for k, v in cos.items())
          + f" (bar {SAME_ROUNDING_BAR} on latent and clipwise_logits); max |long - mean of "
          f"per-crop forwards| {d_mean:.3g} (bar 1e-6); batches of {B_KERNEL} vs {LONG_B} "
          f"rows {d_rows:.3g}; {LONG_B * 1000 / k_ms:.2f} clips/s of 120 s ({k_ms:.1f} ms), "
          f"plain bf16 {LONG_B * 1000 / p_ms:.2f} ({p_ms:.1f} ms) ({smi})", flush=True)
    _require(finite and shapes["framewise_output"] == (LONG_B, 1024, 527),
             f"long-clip outputs {shapes} finite {finite}")
    _require(min(cos["latent_output"], cos["clipwise_logits"]) >= SAME_ROUNDING_BAR,
             f"long-clip kernel vs plain {cos}")
    _require(d_mean <= 1e-6, f"long-clip result vs the mean of per-crop forwards: {d_mean}")
    return counts


def _phase_recon(smi: str, dev):
    """MAE reconstruction on K9's forward kernels, both towers."""
    import numpy as np
    import torch

    from heart_murmur_detection_tpu_torch.analysis.masked_spec import reconstruct
    from heart_murmur_detection_tpu_torch.models import vit_mae

    counts = {}
    for tower, cfg in (("operaGT", vit_mae.mae_vit_small_config()),
                       ("audiomae", vit_mae.audiomae_base_config())):
        model = vit_mae.MaskedAutoencoderViT(cfg, decoder=True)
        vit_mae.init_weights(model, torch.Generator().manual_seed(SEED))
        model = model.to(dev).eval()
        g = torch.Generator().manual_seed(SEED + 35)
        mel = torch.rand(RECON_B, *cfg.img_size, generator=g).numpy()
        _reset_counts()
        k = reconstruct(model, mel, seed=SEED, mm_dtype=torch.bfloat16, impl="kernel")
        c = _all_counts()
        counts[tower] = c
        p = reconstruct(model, mel, seed=SEED, mm_dtype=torch.bfloat16, impl="plain")
        same_mask = np.array_equal(k[1], p[1])
        cos = min(_cos(a, b) for a, b in zip(k[2], p[2]))
        rel = abs(k[3] - p[3]) / abs(p[3])
        k_ms = _time_ms(lambda: reconstruct(model, mel, seed=SEED, mm_dtype=torch.bfloat16),
                        iters=3, warm=1)
        names = ("vit_qkv", "vit_attn", "vit_proj", "vit_mlp")
        print(f"[analysis] reconstruction {tower} B={RECON_B} {cfg.img_size}: launches "
              + ", ".join(f"{n} {c[n]}" for n in names)
              + f"; mask equal to the plain flow's {same_mask}; recon min cos {cos:.7f} (bar "
              f"{SAME_ROUNDING_BAR}); loss {k[3]:.6f} vs plain {p[3]:.6f} (rel {rel:.2e}, bar "
              f"1e-3); {k_ms:.1f} ms a batch ({smi})", flush=True)
        _require(all(c[n] == cfg.depth for n in names), f"{tower} reconstruction launches {c}")
        _require(same_mask and cos >= SAME_ROUNDING_BAR and rel <= 1e-3,
                 f"{tower} reconstruction: mask {same_mask} cos {cos} loss rel {rel}")
        del model
        torch.cuda.empty_cache()
    return counts


def _phase_trace(root: str):
    """utils.profiling.trace in a fresh child: its file holds swin_attn's
    device records by name."""
    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ)
        subprocess.run([sys.executable, "-c", TRACE_CHILD.format(root=root, out=out)],
                       check=True, timeout=300, env=env, cwd=root)
        path = os.path.join(out, "smoke", "trace.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    attn = [e for e in kernels if "swin_attn_kernel" in e.get("name", "")]
    print(f"[analysis] trace: {len(kernels)} device kernel records, {len(attn)} of them "
          f"swin_attn_kernel (a forward launches 12)", flush=True)
    _require(len(attn) > 0, "the trace file holds no swin_attn device record")


def phase_analysis(smi: str, dev, root: str):
    """Phase 33: saliency, long-clip inference and tscam, reconstruction,
    a trace (see the module doc); returns the long-clip path's launches."""
    t_phase = time.time()
    _phase_saliency(smi, dev)
    long = _phase_long(smi, dev)
    _phase_recon(smi, dev)
    _phase_trace(root)
    print(f"[analysis] phase 33 took {time.time() - t_phase:.1f} s", flush=True)
    return long


def _entries(meas: dict, counts: dict, src: dict) -> list:
    """The kernels JSON entries, each built with its launch count."""
    return [
        {"name": name, "route": "cuda", "source": src[name][0], "replaces": src[name][1],
         "launches": counts[name], "max_abs_err": v["err"], "ms": v["ms"],
         "plain_ms": v["plain_ms"], "bound_ms": v["work"].bound_ms,
         "bound_by": v["work"].bound_by, "library_ms": v["library_ms"]}
        for name, v in meas.items()
    ]


KERNEL_SOURCES = {
    "swin_attn": ("heart_murmur_detection_tpu_torch/csrc/swin_attn.cu",
                  "heart_murmur_detection_tpu/ops/pallas_swin.py:97"),
    "swin_mlp": ("heart_murmur_detection_tpu_torch/csrc/swin_mlp.cu",
                 "heart_murmur_detection_tpu/ops/pallas_swin.py:388"),
    "swin_attn_bwd": ("heart_murmur_detection_tpu_torch/csrc/swin_attn_bwd.cu",
                      "heart_murmur_detection_tpu/ops/pallas_swin_train.py:320"),
    "swin_mlp_bwd": ("heart_murmur_detection_tpu_torch/csrc/swin_mlp_bwd.cu",
                     "heart_murmur_detection_tpu/ops/pallas_swin_train.py:271"),
    "swin_wgrad": ("heart_murmur_detection_tpu_torch/csrc/swin_wgrad.cu",
                   "heart_murmur_detection_tpu/ops/pallas_swin_train.py:606"),
    "swin_reduce": ("heart_murmur_detection_tpu_torch/csrc/swin_wgrad.cu",
                    "heart_murmur_detection_tpu/ops/pallas_swin_train.py:606"),
    "vit_qkv": ("heart_murmur_detection_tpu_torch/csrc/vit_qkv.cu",
                "heart_murmur_detection_tpu/ops/pallas_vit.py:66"),
    "vit_attn": ("heart_murmur_detection_tpu_torch/csrc/vit_attn.cu",
                 "heart_murmur_detection_tpu/ops/pallas_vit.py:66"),
    "vit_proj": ("heart_murmur_detection_tpu_torch/csrc/vit_proj.cu",
                 "heart_murmur_detection_tpu/ops/pallas_vit.py:66"),
    "vit_mlp": ("heart_murmur_detection_tpu_torch/csrc/swin_mlp.cu",
                "heart_murmur_detection_tpu/ops/pallas_vit.py:149"),
    "vit_attn_bwd": ("heart_murmur_detection_tpu_torch/csrc/vit_attn_bwd.cu",
                     "heart_murmur_detection_tpu/ops/pallas_vit_train.py:246"),
    "vit_mlp_bwd": ("heart_murmur_detection_tpu_torch/csrc/swin_mlp_bwd.cu",
                    "heart_murmur_detection_tpu/ops/pallas_vit_train.py:163"),
    "logmel": ("heart_murmur_detection_tpu_torch/csrc/logmel.cu",
               "heart_murmur_detection_tpu/ops/pallas_mel.py:54"),
    # vit_attn's modes of the TPU attention-half kernels K10 (body `kernel`)
    # and K11 (body `attn_kernel`)
    **{f"vit_attn:{m}": ("heart_murmur_detection_tpu_torch/csrc/vit_attn.cu", r) for m, r in (
        ("norm_before", "bench/gt_attn_opt.py:50; bench/vit_attn_ablate.py:43"),
        ("fast", "bench/gt_attn_opt.py:50"),
        ("bf16_exp", "bench/gt_attn_opt.py:50"),
        ("no_softmax", "bench/vit_attn_ablate.py:43"),
        ("q_passthrough", "bench/gt_attn_opt.py:50; bench/vit_attn_ablate.py:43"))},
    # the four ViT kernels at HeAR's ViT-L geometry: K6 fused_vit_attn and
    # K7 fused_vit_mlp, which the JAX package's HeAR extraction runs
    "vit_qkv@hear": ("heart_murmur_detection_tpu_torch/csrc/vit_rows.cu",
                     "heart_murmur_detection_tpu/ops/pallas_vit.py:341"),
    "vit_attn@hear": ("heart_murmur_detection_tpu_torch/csrc/vit_attn.cu",
                      "heart_murmur_detection_tpu/ops/pallas_vit.py:341"),
    "vit_proj@hear": ("heart_murmur_detection_tpu_torch/csrc/vit_proj.cu",
                      "heart_murmur_detection_tpu/ops/pallas_vit.py:341"),
    "vit_mlp@hear": ("heart_murmur_detection_tpu_torch/csrc/vit_rows.cu",
                     "heart_murmur_detection_tpu/ops/pallas_vit.py:373"),
    # K1-K3 on the CLAP-2023 path: the operaCT geometry (phase 3's readings)
    "swin_attn@clap2023": ("heart_murmur_detection_tpu_torch/csrc/swin_attn.cu",
                           "heart_murmur_detection_tpu/ops/pallas_swin.py:97"),
    "swin_mlp@clap2023": ("heart_murmur_detection_tpu_torch/csrc/swin_mlp.cu",
                          "heart_murmur_detection_tpu/ops/pallas_swin.py:388"),
    # K1-K3 on the long-clip path (models/htsat.py::htsat_forward_long)
    "swin_attn@long": ("heart_murmur_detection_tpu_torch/csrc/swin_attn.cu",
                       "heart_murmur_detection_tpu/ops/pallas_swin.py:97"),
    "swin_mlp@long": ("heart_murmur_detection_tpu_torch/csrc/swin_mlp.cu",
                      "heart_murmur_detection_tpu/ops/pallas_swin.py:388"),
}


def _merge(a: dict, b: dict) -> dict:
    """One kernel's measurements on two main paths, summed (the weight
    products and reductions of a COLA step and of an Audio-MAE step)."""
    lib = None if a["library_ms"] is None else a["library_ms"] + b["library_ms"]
    work = Work()
    for w in (a["work"], b["work"]):
        work.t_bytes += w.t_bytes
        work.t_ops += w.t_ops
        work.bound_s += w.bound_s
    return {"ms": a["ms"] + b["ms"], "plain_ms": a["plain_ms"] + b["plain_ms"],
            "err": max(a["err"], b["err"]), "work": work, "library_ms": lib}


_TICKS = []


def _tick(label):
    """Print the seconds since the last tick (None: start the clock)."""
    now = time.time()
    if label is not None:
        print(f"[time] {label} took {now - _TICKS[-1]:.1f} s ({now - _TICKS[0]:.1f} s in all)",
              flush=True)
    _TICKS.append(now)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    root_dir = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root_dir, "heart_murmur_detection_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repo (package not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, root_dir)
    # every plain version run here is a float32 reference: no TF32 in its
    # products (cuDNN convolutions would default to it)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    from heart_murmur_detection_tpu_torch.extract.registry import initialize_pretrained_model

    _tick(None)
    smi = phase_card()
    build_log = phase_build()
    dev = torch.device("cuda")
    model = initialize_pretrained_model("operaCT", random_init=True, seed=SEED).to(dev)
    eval_meas = phase_kernels(model, dev)
    train_meas = phase_train_kernels(model, dev)
    _tick("phases 1-3, 7")
    del model
    with tempfile.TemporaryDirectory() as d:
        ex, paths, served, serve_counts = phase_serving(d)
        phase_numerics(ex, paths, served)
        phase_throughput(ex, smi)
        del ex
        torch.cuda.empty_cache()
        cp_counts = phase_cp(smi, dev)
        _tick("phases 4-6, 8")
        torch.cuda.empty_cache()
        vit_meas, gt_counts = phase_mae(paths, smi, dev)
        _tick("phases 9-13")
    torch.cuda.empty_cache()
    vit_train_meas = phase_vit_train_kernels(dev)
    torch.cuda.empty_cache()
    mae_counts = phase_mae_cp(smi, dev)
    _tick("phases 14-17")
    torch.cuda.empty_cache()
    logmel_meas = phase_logmel(smi)
    logmel_counts = phase_main_path(smi)
    phase_logmel_throughput(smi)
    _tick("phases 18-19")
    torch.cuda.empty_cache()
    ablate_meas, ablate_counts = phase_attn_ablate(smi)
    _tick("phase 20")
    torch.cuda.empty_cache()
    phase_finetune(smi, dev)
    _tick("phase 21")
    torch.cuda.empty_cache()
    hear_meas = phase_hear_kernels(dev, build_log, smi)
    torch.cuda.empty_cache()
    hear_counts = phase_hear(smi)
    _tick("phases 22-23")
    torch.cuda.empty_cache()
    clap_counts = phase_clap(smi)
    _tick("phase 24")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        phase_loop(smi, root)
        _tick("phase 25")
        torch.cuda.empty_cache()
        t0 = time.time()
        scores = phase_operace(smi, root)
        phase_operace_train(smi, root, dev, scores)
        torch.cuda.empty_cache()
        phase_baselines(smi, root)
        print(f"[zoo] phases 26-28 took {time.time() - t0:.1f} s", flush=True)
        _tick("phases 26-28")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        phase_respiratory(smi, root)
        phase_resp_cp(smi, root)
        print(f"[resp] phases 29-30 took {time.time() - t0:.1f} s", flush=True)
        _tick("phases 29-30")
    torch.cuda.empty_cache()
    phase_dp(smi, dev)
    _tick("phase 31")
    torch.cuda.empty_cache()
    phase_tp(smi, dev)
    _tick("phase 32")
    torch.cuda.empty_cache()
    long_counts = phase_analysis(smi, dev, root_dir)
    _tick("phase 33")
    torch.cuda.empty_cache()
    phase_zoo_tp(smi, dev)
    _tick("phase 34")
    _require("jax" not in sys.modules, "jax was imported")
    # the weight products and reductions: a COLA step and an Audio-MAE step,
    # launched on both CP paths
    for k in ("swin_wgrad", "swin_reduce"):
        train_meas[k] = _merge(train_meas[k], vit_train_meas.pop(k))
        cp_counts[k] += mae_counts[k]
    kernels = _entries(eval_meas, serve_counts, KERNEL_SOURCES)
    kernels += _entries(train_meas, cp_counts, KERNEL_SOURCES)
    kernels += _entries(vit_meas, gt_counts, KERNEL_SOURCES)
    kernels += _entries(vit_train_meas, mae_counts, KERNEL_SOURCES)
    kernels += _entries(logmel_meas, logmel_counts, KERNEL_SOURCES)
    kernels += _entries({f"vit_attn:{m}": v for m, v in ablate_meas.items()},
                        {f"vit_attn:{m}": n for m, n in ablate_counts.items()}, KERNEL_SOURCES)
    kernels += _entries(hear_meas, {f"{k}@hear": hear_counts[k]
                                    for k in ("vit_qkv", "vit_attn", "vit_proj", "vit_mlp")},
                        KERNEL_SOURCES)
    kernels += _entries({f"{k}@clap2023": eval_meas[k] for k in ("swin_attn", "swin_mlp")},
                        {f"{k}@clap2023": clap_counts[k] for k in ("swin_attn", "swin_mlp")},
                        KERNEL_SOURCES)
    # K1-K3 on the long-clip path: B=16 batches of the operaCT geometry
    # (phase 3's readings)
    kernels += _entries({f"{k}@long": eval_meas[k] for k in ("swin_attn", "swin_mlp")},
                        {f"{k}@long": long_counts[k] for k in ("swin_attn", "swin_mlp")},
                        KERNEL_SOURCES)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
