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
  5. numerics: served features against the port's plain paths on the card
  6. throughput: device-resident 10-s clips at B=64, kernel path and plain
The line before the last is the kernels JSON; the last line is the result
JSON. Imports nothing of JAX.
"""

from __future__ import annotations

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


def phase_kernels(model, dev):
    """Each kernel vs its plain version at the main path's stage geometries.
    Returns the kernels JSON entries (times summed over one forward's 12
    launches of each kernel at B=16)."""
    import torch

    from heart_murmur_detection_tpu_torch.ops import swin

    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    stages = model.htsat.prepared(torch.bfloat16)
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "err": 0.0} for k in ("swin_attn", "swin_mlp")}
    for i, st in enumerate(stages):
        C, H = st.blocks[0].dim, 64 >> i
        x = (torch.randn(B_KERNEL, H, H, C, generator=g) * 0.5).to(dev, torch.bfloat16)
        shifts = (0, st.shift) if st.shift else (0,)
        for s in shifts:
            p = st.blocks[1 if s else 0]
            m = st.mask if s else None
            n_launch = len(st.blocks) // len(shifts)  # launches at this shift per forward
            cases = [("swin_attn", lambda: swin.swin_attn(x, p, m, s),
                      lambda: swin.swin_attn_ref(x, p, m, s))]
            if s == 0:
                cases.append(("swin_mlp", lambda: swin.swin_mlp(x, p), lambda: swin.swin_mlp_ref(x, p)))
                n_mlp = len(st.blocks)
            xf = x.float()
            for name, kern, plain in cases:
                got, want = kern(), plain()
                torch.cuda.synchronize()
                cos = _cos((got.float() - xf).cpu(), (want.float() - xf).cpu())
                err = float((got.float() - want.float()).abs().max())
                k_ms, p_ms = _time_ms(kern), _time_ms(plain, iters=5, warm=1)
                n = n_launch if name == "swin_attn" else n_mlp
                tot[name]["ms"] += n * k_ms
                tot[name]["plain_ms"] += n * p_ms
                tot[name]["err"] = max(tot[name]["err"], err)
                print(f"[kernel] {name} C={C} H=W={H} shift={s} B={B_KERNEL}: branch cos {cos:.7f} "
                      f"max|d| {err:.4g} kernel {k_ms:.4f} ms plain {p_ms:.4f} ms", flush=True)
                _require(cos >= KERNEL_BAR, f"{name} C={C} shift={s} branch cosine {cos} < {KERNEL_BAR}")
    src = {"swin_attn": ("heart_murmur_detection_tpu_torch/csrc/swin_attn.cu",
                         "heart_murmur_detection_tpu/ops/pallas_swin.py:97"),
           "swin_mlp": ("heart_murmur_detection_tpu_torch/csrc/swin_mlp.cu",
                        "heart_murmur_detection_tpu/ops/pallas_swin.py:388")}
    return [
        {"name": k, "route": "cuda", "source": src[k][0], "replaces": src[k][1],
         "tpu_entry_points": ["heart_murmur_detection_tpu/ops/pallas_swin.py:480",
                              "heart_murmur_detection_tpu/ops/pallas_swin.py:847",
                              "heart_murmur_detection_tpu/ops/pallas_swin.py:618"],
         "launches": None, "max_abs_err": v["err"], "ms": v["ms"], "plain_ms": v["plain_ms"]}
        for k, v in tot.items()
    ]


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
            mel, nf = ex._mel(ex._prologue(wav), lengths)
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


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "heart_murmur_detection_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repo (package not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    # every plain version run here is a float32 reference: no TF32 in its
    # products (cuDNN convolutions would default to it)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    from heart_murmur_detection_tpu_torch.extract.registry import initialize_pretrained_model

    smi = phase_card()
    phase_build()
    dev = torch.device("cuda")
    model = initialize_pretrained_model("operaCT", random_init=True, seed=SEED).to(dev)
    kernels = phase_kernels(model, dev)
    del model
    with tempfile.TemporaryDirectory() as d:
        ex, paths, served, counts = phase_serving(d)
        phase_numerics(ex, paths, served)
    phase_throughput(ex, smi)
    for k in kernels:
        k["launches"] = counts[k["name"]]
    _require("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
