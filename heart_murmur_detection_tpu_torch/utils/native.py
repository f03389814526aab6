"""ctypes bindings for the C++ host audio runtime (native/hmdt_native.cpp) with
a threaded prefetch loader — a copy of heart_murmur_detection_tpu/utils/
native.py (`decode_wav` :72, `trim_bounds` :86, `load_clip` :103,
`PrefetchLoader` :130), pinned to the original by tests/test_torch_native.py.

The library is built at first use from the repository's own source with
native/build.sh's flags,

    g++ -O3 -march=native -fPIC -shared -std=c++17 native/hmdt_native.cpp
        -o heart_murmur_detection_tpu_torch/build/native-<key>/libhmdt_native.so

keyed by a hash of the source, the flags, the machine and the CPU (a
-march=native build runs only on the CPU it was built for, so a build
directory copied to another host is never loaded there). The prebuilt
native/libhmdt_native.so is never loaded. A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import queue
import shutil
import subprocess
import tempfile
import threading
from typing import Sequence, Tuple

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(PKG_DIR), "native", "hmdt_native.cpp")
BUILD_DIR = os.path.join(PKG_DIR, "build")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]


def _cpu_id() -> str:
    """The host's CPU model and feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.processor()


def build_key(source: str = SOURCE) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(platform.machine().encode())
    h.update(_cpu_id().encode())
    with open(source, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def build(source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """Compile the source with g++ unless this host's build exists; returns
    the library's path. Raises RuntimeError when the compiler is missing or
    fails."""
    out_dir = os.path.join(build_dir, "native-" + build_key(source))
    lib = os.path.join(out_dir, "libhmdt_native.so")
    if os.path.exists(lib):
        return lib
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ or $CXX): the native host loader cannot be built")
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, source], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {source}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def load_native() -> ctypes.CDLL:
    """Build if needed and load the library, every signature declared."""
    lib = ctypes.CDLL(build())
    lib.hmdt_decode_wav.restype = ctypes.c_long
    lib.hmdt_decode_wav.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.hmdt_free.argtypes = [ctypes.c_void_p]
    lib.hmdt_trim_bounds.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.hmdt_load_clip.restype = ctypes.c_long
    lib.hmdt_load_clip.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_long,
        ctypes.c_long,
    ]
    return lib


def decode_wav(path: str) -> Tuple[np.ndarray, int]:
    """PCM 8/16/24/32 or float WAV -> (float32 mono, its rate); no resampling."""
    lib = load_native()
    ptr = ctypes.POINTER(ctypes.c_float)()
    sr = ctypes.c_int()
    n = lib.hmdt_decode_wav(path.encode(), ctypes.byref(ptr), ctypes.byref(sr))
    if n < 0:
        raise IOError(f"native decode failed: {path}")
    out = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    lib.hmdt_free(ptr)
    return out, sr.value


def trim_bounds(y: np.ndarray, frame: int, hop: int, top_db: float = 60.0):
    """librosa.effects.trim's (start, end) sample bounds."""
    lib = load_native()
    y = np.ascontiguousarray(y, np.float32)
    s = ctypes.c_long()
    e = ctypes.c_long()
    lib.hmdt_trim_bounds(
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(y),
        frame,
        hop,
        top_db,
        ctypes.byref(s),
        ctypes.byref(e),
    )
    return s.value, e.value


def load_clip(
    path: str,
    max_len: int,
    min_len: int,
    pad_zero: bool = True,
    sr: int = 16000,
) -> Tuple[np.ndarray, int]:
    """decode + trim + pad into a fresh buffer (get_entire_signal's policy):
    (buffer, valid length). ValueError for a file at another rate, IOError
    for one the decoder cannot read."""
    lib = load_native()
    buf = np.zeros(max(max_len, min_len), np.float32)
    n = lib.hmdt_load_clip(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_len,
        min_len,
        1 if pad_zero else 0,
        sr,
        sr // 10,
        sr // 20,
    )
    if n == -2:
        raise ValueError("sample-rate mismatch; use the python path to resample")
    if n < 0:
        raise IOError(f"native load failed: {path}")
    return buf, int(n)


class PrefetchLoader:
    """Threaded clip prefetcher: host threads load batch k+1 while the device
    computes batch k. Yields (offset, count, (batch_size, max_len) float32
    waveforms, int32 lengths) in order."""

    def __init__(
        self,
        paths: Sequence[str],
        batch_size: int,
        max_len: int,
        min_len: int,
        pad_zero: bool = True,
        sr: int = 16000,
        num_threads: int = 2,
        depth: int = 2,
        loader=None,
    ):
        self.paths = list(paths)
        self.bs = batch_size
        self.max_len = max_len
        self.min_len = min_len
        self.pad_zero = pad_zero
        self.sr = sr
        self._load = loader or (lambda p: load_clip(p, max_len, min_len, pad_zero, sr))
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: list = []
        self.t = threading.Thread(target=self._work, args=(num_threads,), daemon=True)
        self.t.start()

    def _work(self, num_threads: int):
        from concurrent.futures import ThreadPoolExecutor

        try:
            with ThreadPoolExecutor(num_threads) as pool:
                for lo in range(0, len(self.paths), self.bs):
                    batch_paths = self.paths[lo : lo + self.bs]
                    results = list(pool.map(self._load, batch_paths))
                    wav = np.zeros((self.bs, self.max_len), np.float32)
                    lengths = np.zeros(self.bs, np.int32)
                    for i, (buf, n) in enumerate(results):
                        m = min(n, self.max_len)
                        wav[i, :m] = buf[:m]
                        lengths[i] = m
                    self.q.put((lo, len(batch_paths), wav, lengths))
        except BaseException as e:  # noqa: BLE001 — re-raised in __iter__
            self._err.append(e)
        finally:
            self.q.put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                break
            yield item
        if self._err:
            raise self._err[0]
