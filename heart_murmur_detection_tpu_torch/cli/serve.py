"""Feature-extraction serving daemon — counterpart of
heart_murmur_detection_tpu/cli/serve.py, on the port's FeatureExtractor.

Usage:
  python -m heart_murmur_detection_tpu_torch.cli.serve pretrain=operaCT dim=768 random_init=True
  python -m heart_murmur_detection_tpu_torch.cli.serve pretrain=operaGT random_init=True
  python -m heart_murmur_detection_tpu_torch.cli.serve pretrain=audiomae random_init=True
  (reads configs/serve_config.yaml; key=value overrides; device=cpu runs the
  plain torch path without a card; input_sec defaults by tower: 8 s operaCT,
  8.18 s operaGT, 10 s audiomae)

Endpoints:
  GET  /healthz            -> {"status": "ok", "pretrain": ..., "dim": ...}
  POST /extract
       Content-Type: audio/wav  (raw WAV bytes, one clip)
       Content-Type: application/json  {"paths": ["/abs/a.wav", ...]}
       -> {"features": [[...dim floats...], ...], "n": N, "ms": elapsed}

One FeatureExtractor per server, built and warmed (kernels built, one batch
run) before the socket opens. Requests serialize through a lock: batching
happens inside a request, not across competing requests. WAV bytes go
through the same decode/trim/pad policy as offline extraction.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .config import resolve


def _opt(cfg, key):
    v = cfg.get(key)
    return None if v in (None, "None") else v


def _build_extractor(cfg):
    from ..extract.extract import FeatureExtractor
    from ..extract.registry import default_input_sec

    pretrain = cfg.get("pretrain", "operaCT")
    input_sec = _opt(cfg, "input_sec")
    source_sr = _opt(cfg, "source_sr")
    return FeatureExtractor(
        pretrain,
        dim=int(cfg.get("dim", 768)),
        input_sec=float(input_sec) if input_sec is not None else default_input_sec(pretrain),
        ckpt_path=_opt(cfg, "ckpt_path"),
        batch_size=int(cfg.get("batch_size", 16)),
        random_init=bool(cfg.get("random_init", False)),
        wire_format=cfg.get("wire_format", "int16"),
        source_sr=int(source_sr) if source_sr is not None else None,
        fast_softmax=bool(cfg.get("fast_softmax", False)),
        device=cfg.get("device", "cuda"),
        seed=int(cfg.get("seed", 0)),
    )


def _warm(ex):
    """Build the kernels and run one batch on a synthetic clip."""
    import numpy as np

    from ..utils.audio_io import write_wav

    sr = 16000
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "warm.wav")
        t = np.arange(int(ex.input_sec * sr), dtype=np.float32) / sr
        write_wav(p, (0.1 * np.sin(2 * np.pi * 100 * t)).astype(np.float32), sr)
        ex.extract_files([p])


class Handler(BaseHTTPRequestHandler):
    # quiet request logging (stderr noise at serving rates)
    def log_message(self, fmt, *args):
        pass

    def _json(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            c = self.server.cfg
            self._json(200, {"status": "ok", "pretrain": c.get("pretrain"),
                             "dim": c.get("dim")})
        else:
            self._json(404, {"error": "unknown path"})

    def do_POST(self):
        if self.path != "/extract":
            self._json(404, {"error": "unknown path"})
            return
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        ex, lock = self.server.extractor, self.server.lock
        t0 = time.time()
        try:
            if ctype == "application/json":
                req = json.loads(body)
                paths = [str(p) for p in req.get("paths", [])]
                if not paths:
                    self._json(400, {"error": "no paths"})
                    return
                missing = [p for p in paths if not os.path.exists(p)]
                if missing:
                    self._json(400, {"error": f"missing files: {missing[:5]}"})
                    return
                with lock:
                    feats = ex.extract_files(paths)
            elif ctype in ("audio/wav", "audio/x-wav", "application/octet-stream"):
                with tempfile.TemporaryDirectory() as d:
                    p = os.path.join(d, "clip.wav")
                    with open(p, "wb") as f:
                        f.write(body)
                    with lock:
                        feats = ex.extract_files([p])
            else:
                self._json(415, {"error": f"unsupported content-type {ctype!r}"})
                return
        except Exception as e:  # noqa: BLE001 - report, keep serving
            traceback.print_exc()
            self._json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._json(200, {
            "features": [[float(v) for v in row] for row in feats],
            "n": len(feats),
            "ms": round((time.time() - t0) * 1000, 1),
        })


def make_server(cfg, host="127.0.0.1", port=0):
    """Build a server with a warm extractor (srv.extractor); the caller runs
    serve_forever() and shutdown()."""
    extractor = _build_extractor(cfg)
    _warm(extractor)
    srv = ThreadingHTTPServer((host, port), Handler)
    srv.cfg = dict(cfg)
    srv.extractor = extractor
    srv.lock = threading.Lock()
    return srv


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    for cfg in resolve("serve_config", argv):
        host = cfg.get("host", "127.0.0.1")
        port = int(cfg.get("port", 8799))
        srv = make_server(cfg, host, port)
        print(
            f"serving {cfg.get('pretrain')}{cfg.get('dim')} on "
            f"http://{host}:{srv.server_address[1]} (warm)",
            flush=True,
        )
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            srv.shutdown()
        finally:
            srv.server_close()
        break  # one server per invocation; no multirun sweeps


if __name__ == "__main__":
    main()
