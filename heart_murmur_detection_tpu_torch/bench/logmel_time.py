"""The logmel kernel (csrc/logmel.cu) against its plain version, with times.

    python -m heart_murmur_detection_tpu_torch.bench.logmel_time [tag]

At the main path's shapes (operaCT serving B=16 and throughput B=64 of
10-s clips, B=16 of 32-s clips, the operaGT chunk batch of 8.18-s chunks,
and a ragged batch of 3-32 s clips), on seeded noise-plus-tone clips: the
frame counts, the normalised mel of the kernel against the plain version
(max abs difference), two launches bitwise equal, and the CUDA-event time
of the kernel, of the plain version and of the library reference
(torch.stft, i.e. cuFFT, then the power and the mel product: two calls and
the glue), the kernel and the library timed in turns (PAIRS pairs: medians
and each side's readings), with the bound: the function's least work (a
real FFT a frame) at the float32 non-tensor peak, or its bytes at the HBM
rate, whichever is larger; the TPU kernel's dense DFT and mel products at
that peak are reported apart as `dense_ms`.
Then the precision check: on a low-level tone plus noise, the kernel's and
the plain float32 version's max error against a float64 evaluation of the
same function. Last, what torch.profiler records of the kernel's launches
(profiler_view). Prints one line a case, prefixed by `tag`. Needs a card;
chip_smoke.py phase 18 runs the same cases.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..audio import dsp
from ..ops import mel

SR = 16000
F32_FLOPS = 67e12  # H100 SXM float32 non-tensor peak (NVIDIA data sheet)
HBM_BPS = 3.35e12  # H100 SXM HBM3 bytes/s
# the DFT as two dense products over 513 bins and the dense mel product, one
# frame: what the TPU kernel computes (dense_ms)
DENSE_FLOP_FRAME = 2 * 2 * 1024 * 513 + 2 * 513 * 64
PAIRS = 5  # kernel / library timings in turns a case
CASES = (  # (name, B, seconds of each clip; None = ragged 3-32 s)
    ("operaCT serve 10 s", 16, 10.0),
    ("operaCT throughput 10 s", 64, 10.0),
    ("operaCT 32 s", 16, 32.0),
    ("operaGT chunks 8.18 s", 64, 8.18),
    ("ragged 3-32 s", 16, None),
)


def _ms(fn, iters: int = 20, warm: int = 3) -> float:
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


def clips(B: int, sec, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(B, N) float32 batch zero-padded to a multiple of 512, and lengths:
    tones of 60-400 Hz with noise; sec None draws ragged 3-32 s lengths."""
    r = np.random.default_rng(seed)
    lens = (r.integers(3 * SR, 32 * SR, B) if sec is None
            else np.full(B, int(sec * SR)))
    N = (int(lens.max()) + 511) // 512 * 512
    wav = np.zeros((B, N), np.float32)
    for i, n in enumerate(lens):
        t = np.arange(n) / SR
        wav[i, :n] = 0.3 * np.sin(2 * np.pi * r.uniform(60, 400) * t) + 0.05 * r.standard_normal(n)
    return wav, lens.astype(np.int32)


def least_flop_frame() -> float:
    """The least operations of one frame: the Hann window (1024 products), a
    real FFT of 1024 points (2.5 N log2 N, the usual count), the power (3 a
    bin, 513 bins), the mel product over the filterbank's nonzeros (a
    multiply-add each) and the log10 (one a mel)."""
    nnz = int(np.count_nonzero(dsp._mel_fb(SR, 1024, 64, 50.0, 8000.0)))
    return 1024 + 2.5 * 1024 * 10 + 3 * 513 + 2 * nnz + 64.0


def bound(B: int, N: int) -> Dict[str, float]:
    """The least time of one call: the function's least operations
    (least_flop_frame a frame) at the float32 peak, or its bytes (waveform
    and filterbank read once, log-mel written once; an FFT needs no DFT
    bases) at the HBM rate, whichever is larger. dense_ms: the dense DFT
    and mel products at the float32 peak, the TPU kernel's work."""
    T = N // 512 + 1
    flops = B * T * least_flop_frame()
    nbytes = 4 * (B * N + B * T * 64 + 513 * 64)
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BPS
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
            "dense_flops": B * T * DENSE_FLOP_FRAME,
            "dense_ms": B * T * DENSE_FLOP_FRAME / F32_FLOPS * 1e3}


def library_logmel(wav: torch.Tensor) -> torch.Tensor:
    """The library reference: torch.stft (cuFFT) with the periodic Hann window
    and the centre pad, then the power and the slaney-mel product."""
    _, _, fb = dsp._device_constants(wav.device, SR, 1024, 64, 50.0, 8000.0)
    win = torch.hann_window(1024, periodic=True, device=wav.device)
    spec = torch.stft(wav, 1024, 512, window=win, center=True, pad_mode="constant",
                      return_complex=True)  # (B, 513, T)
    power = spec.real.square() + spec.imag.square()
    return torch.log10(torch.clamp(torch.matmul(power.transpose(1, 2), fb), min=1e-10))


def measure(B: int, sec, seed: int = 0) -> Dict[str, object]:
    """One case: agreement, repeatability and times (see the module doc)."""
    dev = torch.device("cuda")
    w, lens = clips(B, sec, seed)
    wav, lengths = torch.from_numpy(w).to(dev), torch.from_numpy(lens).to(dev)
    got, nf = mel.mel_frontend_fused(wav, lengths)
    want, nf_p = mel.mel_frontend_fused(wav, lengths, impl="plain")
    again, _ = mel.mel_frontend_fused(wav, lengths)
    torch.cuda.synchronize()
    lib = library_logmel(wav)
    ref = mel.fused_logmel_ref(wav)
    ks, ls = [], []
    for _ in range(PAIRS):  # kernel and library in turns
        ks.append(_ms(lambda: mel.fused_logmel(wav)))
        ls.append(_ms(lambda: library_logmel(wav), iters=10, warm=2))
    out = {
        "frames_equal": bool(torch.equal(nf, nf_p)) and got.shape == want.shape,
        "max_abs_err": float((got - want).abs().max()),
        "bitwise": bool(torch.equal(got, again)),
        "library_max_abs_log10": float((lib - ref).abs().max()),
        "ms": statistics.median(ks), "ms_runs": ks,
        "plain_ms": _ms(lambda: mel.fused_logmel_ref(wav), iters=5, warm=1),
        "library_ms": statistics.median(ls), "library_runs": ls,
        "B": B, "N": int(w.shape[1]),
    }
    out.update(bound(B, w.shape[1]))
    return out


def precision(seed: int = 1) -> Dict[str, float]:
    """Max |error| of the kernel and of the plain float32 version against a
    float64 evaluation of the same function (the same float32 bases, exact
    in float64), in log10 units, on 4 clips of 10.016 s: a 1e-3 tone at 440 Hz
    plus noise at 1e-5. A single-pass TF32 or bf16 product would be off by
    orders of magnitude more than float32 on the bins far from the tone."""
    r = np.random.default_rng(seed)
    n = 10 * SR + 256  # a multiple of the hop
    t = np.arange(n) / SR
    w = (1e-3 * np.sin(2 * np.pi * 440 * t)[None] + 1e-5 * r.standard_normal((4, n)))
    wav = torch.from_numpy(w.astype(np.float32)).to("cuda")
    ref64 = mel.fused_logmel_ref(wav.double())
    k = mel.fused_logmel(wav).double()
    p = mel.fused_logmel_ref(wav).double()
    torch.cuda.synchronize()
    ek, ep = float((k - ref64).abs().max()), float((p - ref64).abs().max())
    rk = float((k - ref64).square().mean().sqrt())
    rp = float((p - ref64).square().mean().sqrt())
    return {"kernel_err": ek, "plain_err": ep, "ratio": ek / ep if ep else float("inf"),
            "kernel_rms": rk, "plain_rms": rp}


def _profiled(fn, n: int, cpu: bool, pad_cycles: int = 0) -> Dict[str, object]:
    """torch.profiler over n calls of fn: the device events whose name holds
    "logmel" (count, total ms) and the names of all device events. With
    pad_cycles, a spin kernel (torch.cuda._sleep) runs before and after the
    calls inside the profiled window."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    fn()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        if pad_cycles:
            torch.cuda._sleep(pad_cycles)
        for _ in range(n):
            fn()
        if pad_cycles:
            torch.cuda._sleep(pad_cycles)
        torch.cuda.synchronize()
    names, count, us = [], 0, 0.0
    for e in prof.events():
        if str(getattr(e, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        names.append(e.name[:60])
        if "logmel" in e.name:
            count += 1
            us += e.device_time_total if hasattr(e, "device_time_total") else e.cuda_time_total
    return {"logmel_events": count, "logmel_ms": us / 1e3, "device_events": len(names),
            "names": sorted(set(names))}


def profiler_view(B: int = 64, sec: float = 10.0, n: int = 4) -> Dict[str, object]:
    """What torch.profiler records of n back-to-back logmel launches on a
    B x sec batch, against their CUDA-event time: CUDA activity alone, with
    CPU activity, and inside a window padded by spin kernels at both ends."""
    w, _ = clips(B, sec, 5)
    wav = torch.from_numpy(w).to("cuda")
    fn = lambda: mel.fused_logmel(wav)  # noqa: E731
    out = {"event_ms_per_launch": _ms(fn), "launches": n}
    out["cuda"] = _profiled(fn, n, cpu=False)
    out["cuda+cpu"] = _profiled(fn, n, cpu=True)
    out["cuda, padded window"] = _profiled(fn, n, cpu=False, pad_cycles=20_000_000)
    return out


def main(argv: List[str] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tag = argv[0] if argv else "logmel"
    if not torch.cuda.is_available():
        print("logmel_time: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version is an f32 reference
    for i, (name, B, sec) in enumerate(CASES):
        print(tag, name, measure(B, sec, seed=i), flush=True)
    print(tag, "precision", precision(), flush=True)
    print(tag, "profiler", profiler_view(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
