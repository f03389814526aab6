"""Build the hand-written CUDA kernels with nvcc and bind them with ctypes.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c csrc/<name>.cu -o build/<hash>/<name>.o   (each, in parallel)
    nvcc -shared -o build/<hash>/libhmdt.so build/<hash>/*.o

The sources have a plain C interface (no PyTorch headers), so a build takes
seconds; the sources compile in parallel, one nvcc each, then link. It
happens at first use, into heart_murmur_detection_tpu_torch/build/ (listed in
.gitignore), keyed by a hash of the sources; nothing is fetched or prebuilt.
A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
LIB_NAME = "libhmdt.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, out, w_qkv, b_qkv, w_proj, b_proj, ln_w, ln_b, bias, mask, kmul,
    # B, H, W, C, heads, shift, fast_softmax, and the plan (ops/swin_plan.py):
    # windows_per_block, cs, proj_width, stages; stream
    "swin_attn_launch": [_vp] * 11 + [_i] * 11 + [_vp],
    # x, out, ln_w, ln_b, w_fc1, b_fc1, w_fc2, b_fc2, kmul,
    # n_tokens, C, hidden, hw, and the plan: panel_rows, ks, stages; eps, stream
    "swin_mlp_launch": [_vp] * 9 + [_i] * 7 + [_f, _vp],
    # x, out, o_ws, w_qkv, b_qkv, w_proj, b_proj, ln_w, ln_b, bias, mask, kmul,
    # B, H, W, C, heads, shift, fast_softmax, and the plan
    # (ops/swin_plan.py::attn_f32_plan): the core's threads and shared bytes,
    # proj's tile rows, columns, threads and shared bytes; stream
    "swin_attn_f32_launch": [_vp] * 12 + [_i] * 13 + [_vp],
    # x, out, g_ws, ln_w, ln_b, w_fc1, b_fc1, w_fc2, b_fc2, kmul, n_tokens, C,
    # hidden, hw, and the plan (mlp_f32_plan): tile rows, columns, threads,
    # shared bytes; eps, stream
    "swin_mlp_f32_launch": [_vp] * 10 + [_i] * 8 + [_f, _vp],
    # x, dh1, kmul, dx, w_qkv, b_qkv, w_proj, ln_w, ln_b, bias, mask,
    # h_g, dw_g, opre_g, dqkv_g, part, dh_ws, wpt_ws, B, H, W, C, heads, shift,
    # and the plan (ops/swin_plan.py): stages, grid; stream
    "swin_attn_bwd_launch": [_vp] * 18 + [_i] * 8 + [_vp],
    # h1, dy, kmul, dh1, ln_w, ln_b, w_fc1, b_fc1, w_fc2, m_g, g_g, dyk_g,
    # da1_g, part, dm_ws, n_tokens, C, hidden, hw, and the plan: panel_rows,
    # stages, grid; eps, stream
    "swin_mlp_bwd_launch": [_vp] * 15 + [_i] * 7 + [_f, _vp],
    # h1, dy, kmul, dh1, ln_w, ln_b, w_fc1, b_fc1, w_fc2, m_g, g_g, dyk_g,
    # da1_g, part, dm_ws, w1t_ws, w2t_ws, n_tokens, C, hidden, hw, and the
    # plan (ops/swin_plan.py::mlp_bwd_f32_plan): the row pass's blocks, the
    # product's tile rows, columns, threads and shared bytes, the row
    # kernels' threads; eps, stream
    "swin_mlp_bwd_f32_launch": [_vp] * 17 + [_i] * 10 + [_f, _vp],
    # x, dh1, kmul, dx, w_qkv, b_qkv, w_proj, ln_w, ln_b, bias, mask, h_g,
    # dw_g, opre_g, dqkv_g, part, d_ws, wpt_ws, wqt_ws, B, H, W, C, heads,
    # shift, and the plan (attn_bwd_f32_plan): the core's runs, threads and
    # shared bytes, the product's tile rows, columns, threads and shared
    # bytes, the row kernels' threads; stream
    "swin_attn_bwd_f32_launch": [_vp] * 19 + [_i] * 14 + [_vp],
    # a, b, out, ws, cnt, n, M, N, chunk, group, rows, stream
    "swin_wgrad_launch": [_vp] * 5 + [_i] * 6 + [_vp],
    # a, b, out, ws, n, M, N, and the plan (wgrad_f32_plan): chunk, the tile
    # side, threads; stream
    "swin_wgrad_f32_launch": [_vp] * 4 + [_i] * 6 + [_vp],
    # ws, out, S, L, stream
    "swin_reduce_launch": [_vp] * 2 + [_i] * 2 + [_vp],
    # x, qkv, h_out, w_qkv, b_qkv, ln_w, ln_b, n_tokens, Np, C, heads, eps, stream
    "vit_qkv_launch": [_vp] * 7 + [_i] * 4 + [_f, _vp],
    # x, qkv, h, w_qkv, b_qkv, ln_w, ln_b, n_tokens, Np, C, heads, and the
    # plan (ops/vit_plan.py): the GEMM's grid; eps, stream
    "vit_qkv_rows_launch": [_vp] * 7 + [_i] * 5 + [_f, _vp],
    # x, out, h, g, ln_w, ln_b, w_fc1, b_fc1, w_fc2, b_fc2, n_tokens, C,
    # hidden, and the plan: fc1's and fc2's grids; eps, stream
    "vit_mlp_rows_launch": [_vp] * 10 + [_i] * 5 + [_f, _vp],
    # qkv, out, B, Np, C, heads, n_real, mode, stream
    "vit_attn_launch": [_vp] * 2 + [_i] * 6 + [_vp],
    # o, x, out, w_proj, b_proj, rows, C, stream
    "vit_proj_launch": [_vp] * 5 + [_i] * 2 + [_vp],
    # x, dh1, dx, w_qkv, b_qkv, w_proj, ln_w, ln_b, h_g, opre_g, dqkv_g, part,
    # qkv_ws, do_ws, stats_ws, dh_ws, B, Np, C, heads, n_real, tpb, eps, stream
    "vit_attn_bwd_launch": [_vp] * 16 + [_i] * 6 + [_f, _vp],
    # a, b, out, M, N, K, stream (vit_attn_bwd's token-row product alone, for
    # the tests)
    "vit_mm_launch": [_vp] * 3 + [_i] * 3 + [_vp],
    # x, qkv, w_qkv, b_qkv, ln_w, ln_b, n_tokens, C, and the plan
    # (ops/vit_plan.py::qkv_f32_plan): tile rows, columns, threads, shared
    # bytes; eps, stream
    "vit_qkv_f32_launch": [_vp] * 6 + [_i] * 6 + [_f, _vp],
    # qkv, o, B, Np, C, heads, n_real, and the plan (vit_plan.attn_f32_plan):
    # the core's threads and shared bytes; stream
    "vit_attn_f32_launch": [_vp] * 2 + [_i] * 7 + [_vp],
    # o, x, out, w_proj, b_proj, n_tokens, C, and the plan (proj_f32_plan):
    # tile rows, columns, threads, shared bytes; stream
    "vit_proj_f32_launch": [_vp] * 5 + [_i] * 6 + [_vp],
    # x, dh1, dx, w_qkv, b_qkv, w_proj, ln_w, ln_b, h_g, opre_g, dqkv_g, part,
    # qkv_ws, do_ws, stats_ws, d_ws, wpt_ws, wqt_ws, B, Np, C, heads, n_real,
    # and the plan (vit_plan.attn_bwd_f32_plan): the row pass's blocks, the
    # attention passes' threads and shared bytes (query, key), the product's
    # tile rows, columns, threads and shared bytes, the row kernels'
    # threads; eps, stream
    "vit_attn_bwd_f32_launch": [_vp] * 18 + [_i] * 14 + [_f, _vp],
    # wav, out, cos, sin, fb, B, N, stream
    "logmel_launch": [_vp] * 5 + [_i] * 2 + [_vp],
}


def _sources():
    return sorted(
        os.path.join(CSRC_DIR, f)
        for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cands = [os.path.join(os.environ[k], "bin", "nvcc")
             for k in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(k)]
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


class BuildResult:
    def __init__(self, path: str, seconds: float, log: str):
        self.path, self.seconds, self.log = path, seconds, log


def build() -> BuildResult:
    """Compile csrc/*.cu into BUILD_DIR/<hash>/ unless already built: one
    nvcc per source, all started together, then one link."""
    out_dir = os.path.join(BUILD_DIR, source_hash())
    lib = os.path.join(out_dir, LIB_NAME)
    log_path = lib + ".log"
    if os.path.exists(lib):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return BuildResult(lib, 0.0, log)
    os.makedirs(out_dir, exist_ok=True)
    nvcc = find_nvcc()
    cu = [s for s in _sources() if s.endswith(".cu")]
    objs = [os.path.join(out_dir, os.path.basename(s)[:-3] + ".o") for s in cu]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.time()
    procs = [
        (subprocess.Popen([nvcc, *compile_flags, "-c", src, "-o", obj],
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), src)
        for src, obj in zip(cu, objs)
    ]
    logs, failed = [], []
    for proc, src in procs:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {src}:\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.time() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    log = "".join(logs) + proc.stderr
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, lib)
    return BuildResult(lib, seconds, log)


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernels, with every signature declared."""
    lib = ctypes.CDLL(build().path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
