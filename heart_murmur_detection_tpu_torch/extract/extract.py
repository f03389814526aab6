"""Batched feature extraction — counterpart of
heart_murmur_detection_tpu/extract/extract.py for the ported towers.

  operaCT : whole clip (<= 32 s) -> wire decode [-> upsample] -> device mel
            -> HTS-AT latent (768) [-> g (512)]
  operaCE : whole clip (uncapped) -> wire decode [-> upsample] -> device mel
            -> EfficientNet-B0 with masked pooling (1280) [-> g (512)],
            float32 on cuDNN with TF32 off (also null / null-efficientnet)
  operaGT : 8.18 s 50%-hop chunks -> device mel -> ViT-S forward_feature ->
            mean over a file's chunks (384)
  audiomae: 10 s non-overlapping chunks (+ tail) -> device kaldi fbank ->
            ViT-B global-pool backbone -> mean over a file's chunks (768)

The host decodes, trims, splits and pads; the device runs the wire decode,
the upsample from source_sr (ops/resample.py), the spectrogram frontend
(with use_pallas_mel, the fused log-mel kernel of ops/mel.py) and the
encoder, whose blocks are the CUDA kernels of ops/swin.py (HTS-AT) or
ops/vit.py (the MAE ViTs) under the bf16 flow on a card.

Whole clips of operaCT at 16 kHz are loaded by the C++ host loader
(utils/native.py, the JAX extract.py:452-505 route) on two threads a batch
ahead; other rates and formats take the Python decoder per file.

Host pipeline (the JAX two-stage pack || put, extract.py:505-511): one
worker thread packs batches (pad_batch + wire encode) into numpy, a second
pins them and copies them to the card with non_blocking=True on a side
stream, recording an event the compute stream waits on; each batch's result
is copied back asynchronously into pinned memory, and the host syncs one
batch behind, so packing, transfers and compute overlap.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..audio import dsp, pipelines, wire
from ..audio.pad import split_pad_sample, split_sample_simple
from ..ops.resample import resample_poly_device
from ..utils.precision import strict_f32
from . import registry

SR = 16000


def _batched(n: int, bs: int):
    for i in range(0, n, bs):
        yield i, min(i + bs, n)


class FeatureExtractor:
    """Batched extraction for one encoder (operaCT, operaCE or its null
    baselines, operaGT or an audiomae kind) on one device.

    device: "cuda" (the default) or "cpu"; a CUDA device without a card
    raises. compute_dtype: torch.bfloat16 (the default) is the bf16 flow
    that runs the CUDA kernels on a card; torch.float32 is the strict path
    and runs only on the CPU here (the float32 kernels are not ported).
    dim selects the operaCT output (768 latent or 512 projection) or the
    operaCE one (1280, the default as in the JAX extractor, or 512); the MAE
    towers give their embedding width (384 operaGT, 768 audiomae). operaCE
    runs the JAX extractor's float32 graph (Cola.extract_feature on the
    EfficientNet, convolutions on cuDNN with TF32 off) whatever
    compute_dtype says, and its clips are not capped at 32 s. As in
    the JAX extractor, which fuses only dim 768 (its extract.py:389), a
    512-d operaCT batch runs the reference's strict float32 graph
    (Cola.extract_feature: plain products, TF32 off) whatever
    compute_dtype says, so it launches no swin kernel; 768 takes the
    compute_dtype flow (the kernels on a card in bf16).
    use_pallas_mel: the mel of operaCT and operaGT through the fused log-mel
    kernel (ops/mel.py, TPU K4) instead of audio/dsp.mel_frontend; both are
    float32 (audiomae keeps its kaldi fbank either way).
    source_sr: the host decodes, trims and pads at this rate (CirCor 4000)
    and the device upsamples to 16 kHz after the wire decode (ops/resample.py,
    scipy's FIR), which cuts the bytes shipped by 16000 / source_sr; it must
    divide 16000 with a power-of-two ratio of at most 512. As in the JAX
    prologue, the FIR's ringing past each clip's end stays in the padding
    (the 16 kHz host path has zeros there, so a clip's last frames differ).
    fast_softmax: normalise after the P v product (None = on for bf16 on a
    card, the JAX auto choice for a bf16 accelerator); a batch whose
    features come out non-finite is re-run with the stable softmax.
    """

    def __init__(
        self,
        pretrain: str,
        dim: int = 1280,
        input_sec: float = 8,
        ckpt_path: Optional[str] = None,
        batch_size: int = 16,
        pad0: bool = False,
        random_init: bool = False,
        compute_dtype: torch.dtype = torch.bfloat16,
        use_pallas_mel: bool = False,
        wire_format: str = "int16",
        source_sr: Optional[int] = None,
        mesh=None,
        fast_softmax: Optional[bool] = None,
        device="cuda",
        seed: int = 0,
    ):
        self.pretrain = pretrain
        self.is_audiomae = registry.is_audiomae(pretrain)
        self.is_mae = self.is_audiomae or registry.is_operagt(pretrain)
        self.is_ce = registry.is_operace(pretrain)
        if not (self.is_mae or self.is_ce or registry.is_operact(pretrain)):
            raise NotImplementedError(f"pretrain {pretrain!r}: no extractor for this kind")
        if self.is_ce and dim not in (1280, 512):
            raise NotImplementedError(f"operaCE dim {dim}: 1280 or 512")
        if not (self.is_mae or self.is_ce) and dim not in (768, 512):
            raise NotImplementedError(f"operaCT dim {dim}: 768 or 512")
        if source_sr is not None and (SR % source_sr or 512 % (SR // source_sr)):
            raise ValueError(f"source_sr must divide {SR} with power-of-two ratio <=512")
        self.source_sr = source_sr
        self._up = SR // source_sr if source_sr else 1
        self.use_pallas_mel = use_pallas_mel
        if mesh is not None:
            raise NotImplementedError("mesh (multi-device extraction) is not ported")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("FeatureExtractor(device='cuda'): no CUDA card available")
            if compute_dtype != torch.bfloat16:
                raise NotImplementedError(
                    "on a card the kernels take bfloat16; the float32 kernels are not ported"
                )
        elif self.device.type != "cpu":
            raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
        self.wire = wire_format
        wire.wire_dtype(wire_format)  # validate early
        self.dim = dim
        self.input_sec = input_sec
        self.batch_size = batch_size
        self.pad0 = pad0
        self.compute_dtype = compute_dtype
        if fast_softmax is None:
            fast_softmax = (self.device.type == "cuda" and compute_dtype == torch.bfloat16
                            and not self.is_ce)
        self.fast_softmax = fast_softmax
        self.model = registry.initialize_pretrained_model(
            pretrain, ckpt_path=ckpt_path, random_init=random_init, seed=seed
        ).to(self.device)
        if self.is_mae:
            self.dim = self.model.config.embed_dim
        self.max_sec = 32 if registry.is_operact(pretrain) else None
        self.n_dispatched = 0  # batches sent through the encoder
        self.route_counts = {"native": 0, "python": 0}  # files a route (_extract_whole_native)
        self._on_card = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if self._on_card else None
        self._fn_stable = None  # lazy stable-softmax re-run (_harvest)
        self._fn = self._build()

    # -- device graphs -------------------------------------------------------
    def _prologue(self, wav: torch.Tensor, lengths: torch.Tensor):
        """Wire decode and the source_sr -> 16 kHz upsample, on the device."""
        wav = wire.decode_device(wav, self.wire)
        if self._up != 1:
            wav = resample_poly_device(wav, self._up)
            lengths = lengths * self._up
        return wav, lengths

    def _mel(self, wav: torch.Tensor, lengths: torch.Tensor):
        if self.use_pallas_mel:
            from ..ops.mel import mel_frontend_fused

            return mel_frontend_fused(wav, lengths)
        return dsp.mel_frontend(wav, lengths)

    def _build(self, fast_softmax: Optional[bool] = None):
        """The batch forward (wav, lengths) -> features (B, dim) on the device."""
        fast = self.fast_softmax if fast_softmax is None else fast_softmax
        model, dim, mm = self.model, self.dim, self.compute_dtype

        if self.is_audiomae:
            from ..models.vit_fused import audiomae_backbone_fused

            def fn(wav, lengths):
                with torch.inference_mode():
                    fb, _ = dsp.kaldi_fbank_frontend(*self._prologue(wav, lengths))
                    return audiomae_backbone_fused(model, fb, mm, fast)

            return fn

        if self.is_mae:  # operaGT
            from ..models.vit_fused import mae_forward_feature_fused

            def fn(wav, lengths):
                with torch.inference_mode():
                    mel, _ = self._mel(*self._prologue(wav, lengths))
                    return mae_forward_feature_fused(model, mel[:, :256], mm, fast)

            return fn

        if self.is_ce or dim == 512:
            # the reference's float32 graph (plain products, TF32 off), whatever
            # compute_dtype says: the JAX extractor runs the EfficientNet in
            # float32 and fuses only operaCT's 768
            def fn(wav, lengths):
                with torch.inference_mode(), strict_f32():
                    mel, nf = self._mel(*self._prologue(wav, lengths))
                    return model.extract_feature(mel, dim, nf, mm_dtype=torch.float32,
                                                 impl="plain")

            return fn

        def fn(wav, lengths):
            with torch.inference_mode():
                mel, nf = self._mel(*self._prologue(wav, lengths))
                return model.extract_feature(mel, dim, nf, mm_dtype=mm, fast_softmax=fast)

        return fn

    def _dispatch(self, wav: torch.Tensor, lengths: torch.Tensor, fn=None):
        """Enqueue one batch; returns a handle _harvest turns into numpy."""
        out = (fn or self._fn)(wav, lengths).to(torch.float32)
        self.n_dispatched += 1
        if not self._on_card:
            return out.numpy(), None
        host = torch.empty(out.shape, dtype=torch.float32, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    def _harvest(self, fut, wav=None, lengths=None) -> np.ndarray:
        """Wait for a dispatched batch, guarding the fast_softmax path: the
        unnormalised softmax overflows float32 exp for attention logits above
        ~88 and every later op keeps the NaN, so a pathological clip shows
        up here as non-finite features, and the batch is re-run once with
        the stable softmax through the same kernels (the JAX package's
        extract.py:188-209)."""
        host, done = fut
        if done is not None:
            done.synchronize()
        out = np.array(host.numpy() if isinstance(host, torch.Tensor) else host)
        if self.fast_softmax and wav is not None and not np.isfinite(out).all():
            if self._fn_stable is None:
                self._fn_stable = self._build(fast_softmax=False)
            out = self._harvest(self._dispatch(wav, lengths, fn=self._fn_stable))
        return out

    @staticmethod
    def _prefetch_iter(gen, depth: int = 3):
        """Run a host batch generator in a worker thread, holding up to
        `depth` results ahead of the consumer."""
        q = queue.Queue(maxsize=depth)
        stop = object()
        err = []

        def run():
            try:
                for v in gen:
                    q.put(v)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                err.append(e)
            finally:
                q.put(stop)

        threading.Thread(target=run, daemon=True).start()
        while True:
            v = q.get()
            if v is stop:
                break
            yield v
        if err:
            raise err[0]

    def _put(self, w: np.ndarray, lengths: np.ndarray):
        """Host batch -> device tensors. On a card: pinned host copy, then a
        non_blocking copy on the side stream with an event the compute
        stream waits on (the wait happens in _consume)."""
        w = torch.from_numpy(w)
        lengths = torch.from_numpy(lengths)
        if not self._on_card:
            return w, lengths, None
        w, lengths = w.pin_memory(), lengths.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            wd = w.to(self.device, non_blocking=True)
            ld = lengths.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._copy_stream)
        return wd, ld, ev

    def _consume(self, batches):
        """Dispatch each (n, wav, lengths, event) batch and harvest the one
        before it (the sync stays one batch behind)."""
        out = []
        pending = None
        for n, wav, lengths, ev in batches:
            if ev is not None:
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(ev)
                # the copies were allocated on the side stream; keep the
                # allocator from reusing them before the compute stream is done
                wav.record_stream(compute)
                lengths.record_stream(compute)
            fut = self._dispatch(wav, lengths)
            if pending is not None:
                pf, pn, pw, pl = pending
                out.append(self._harvest(pf, pw, pl)[:pn])
            pending = (fut, n, wav, lengths)
        if pending is not None:
            pf, pn, pw, pl = pending
            out.append(self._harvest(pf, pw, pl)[:pn])
        return np.concatenate(out, axis=0)

    # -- host orchestration ----------------------------------------------------
    @property
    def _host_sr(self) -> int:
        return self.source_sr or SR

    def _clip_waveform(self, path: str) -> Optional[np.ndarray]:
        types = "zero" if self.pad0 else "repeat"
        return pipelines.get_entire_signal(
            path,
            input_sec=self.input_sec,
            sample_rate=self._host_sr,
            pad=True,
            types=types,
            max_sec=self.max_sec,
        )

    def _chunks(self, path: str) -> List[np.ndarray]:
        """A file's chunks: 10 s non-overlapping windows with the tail, each
        made zero-mean, for audiomae (the keep gate >400 samples, i.e. >25
        ms); input_sec windows at 50% hop, the remainder padded, for
        operaGT. No bandpass filter runs (the JAX _chunks passes None). At
        the host rate; the keep gate counts 16 kHz samples."""
        sr = self._host_sr
        yt = pipelines._load_trim(path, sr)
        if self.is_audiomae:
            chunks = split_sample_simple(yt, 10, sr)
            return [c - c.mean() for c in chunks if len(c) * self._up > 400]
        return split_pad_sample(yt, self.input_sec, sr)

    def extract_files(self, sound_dir_loc: Sequence[str]) -> np.ndarray:
        if self.is_mae:
            return self._extract_chunked(sound_dir_loc)
        return self._extract_whole(sound_dir_loc)

    def _extract_whole(self, paths) -> np.ndarray:
        """Whole clips. operaCT (capped at 32 s) at 16 kHz takes the native
        loader (_extract_whole_native), where the JAX extractor takes it;
        otherwise the Python decode path, where without a cap (operaCE)
        every batch pads to the longest clip."""
        if self.max_sec and self.source_sr is None:
            return self._extract_whole_native(paths)
        sr = self._host_sr
        clips = [self._clip_waveform(p) for p in paths]
        if not clips:
            return np.zeros((0, self.dim), np.float32)
        max_len = int((self.max_sec or max(len(c) / sr for c in clips)) * sr)
        return self.extract_waveforms(clips, max_len=max_len)

    def _extract_whole_native(self, paths) -> np.ndarray:
        """The JAX extract.py:465-505 route: the C++ loader (utils/native.py,
        built at first use; a failed build raises) decodes, trims and pads
        each 16-kHz WAV on two host threads, a batch ahead; a file at another
        rate or not a WAV takes the Python decode + resample of
        _clip_waveform (the JAX `_load`'s except clause). Batches of
        max_sec rounded up to 512 samples then go through the same pack ->
        pinned copy -> compute pipeline as _run. route_counts counts the
        files of each route."""
        from ..utils import native

        native.load_native()
        max_len = ((int(self.max_sec * SR) + 511) // 512) * 512
        min_len = int(self.input_sec * SR)
        lock = threading.Lock()

        def _load(p):
            try:
                out, route = native.load_clip(p, max_len, min_len, self.pad0, SR), "native"
            except (ValueError, IOError):
                w = self._clip_waveform(p)
                buf = np.zeros(max_len, np.float32)
                m = min(len(w), max_len)
                buf[:m] = w[:m]
                out, route = (buf, m), "python"
            with lock:
                self.route_counts[route] += 1
            return out

        if not paths:
            return np.zeros((0, self.dim), np.float32)
        loader = native.PrefetchLoader(list(paths), batch_size=self.batch_size, max_len=max_len,
                                       min_len=min_len, pad_zero=self.pad0, sr=SR, loader=_load)

        def packed():
            for _, k, wav, lengths in loader:
                # the last batch's empty rows repeat its first clip, as _run
                # fills them (the JAX loader leaves them at length 0)
                wav[k:], lengths[k:] = wav[0], lengths[0]
                yield k, wire.encode_np(wav, self.wire), lengths

        return self._pipeline(packed())

    def extract_waveforms(
        self, clips: List[np.ndarray], max_len: Optional[int] = None
    ) -> np.ndarray:
        if max_len is None:
            max_len = max(len(c) for c in clips)
        return self._run(clips, max_len)

    # chunked models (operaGT / audiomae)
    def _extract_chunked(self, paths) -> np.ndarray:
        """Every file's kept chunks through the encoder in batches, then the
        mean feature of each file's chunks (zeros for a file with none)."""
        all_chunks: List[np.ndarray] = []
        owners: List[int] = []
        for i, p in enumerate(paths):
            for c in self._chunks(p):
                # operaGT keeps chunks with >= 16 mel frames (model_util.py:148,
                # hop 512); audiomae keeps every chunk _chunks returns: the
                # reference's fbank gate tests the 128-bin axis and is vacuous
                if self.is_audiomae or len(c) // 512 + 1 >= 16:
                    all_chunks.append(c)
                    owners.append(i)
        feats = self.extract_chunk_waveforms(all_chunks)
        out = np.zeros((len(paths), feats.shape[1]), np.float32)
        cnt = np.zeros(len(paths), np.int64)
        for f, o in zip(feats, owners):
            out[o] += f
            cnt[o] += 1
        return out / np.maximum(cnt, 1)[:, None]

    def extract_chunk_waveforms(self, chunks: List[np.ndarray]) -> np.ndarray:
        """Features of chunks padded to the tower's window: 10 s for
        audiomae, input_sec rounded up to 512 16-kHz samples for operaGT (at
        the host rate)."""
        sr, mult = self._host_sr, 512 // self._up
        if self.is_audiomae:
            max_len = 10 * sr
        else:
            max_len = (int(self.input_sec * sr) + mult - 1) // mult * mult
        return self._run(chunks, max_len)

    def _run(self, clips: List[np.ndarray], max_len: int) -> np.ndarray:
        """Pack, copy and run fixed-size batches of clips; (len(clips), dim)."""
        bs = self.batch_size
        if not clips:
            return np.zeros((0, self.dim), np.float32)

        def packed():
            for lo, hi in _batched(len(clips), bs):
                chunk = clips[lo:hi]
                if len(chunk) < bs:  # pad batch to fixed size, drop extras
                    chunk = chunk + [chunk[0]] * (bs - len(chunk))
                wav, lengths = dsp.pad_batch(chunk, pad_to_multiple=512 // self._up,
                                             max_len=max_len)
                yield hi - lo, wire.encode_np(wav, self.wire), lengths

        return self._pipeline(packed())

    def _pipeline(self, packed) -> np.ndarray:
        """Features of the (n, packed wav, lengths) batches of `packed`:
        two pipeline threads, stage 1 packing (the generator itself: the
        CPU-bound wire encode), stage 2 pinning and starting the copy to the
        card, so pack(i+2) overlaps copy(i+1) overlaps compute(i)."""

        def put(gen):
            for n, w, lengths in gen:
                yield (n, *self._put(w, lengths))

        return self._consume(self._prefetch_iter(put(self._prefetch_iter(packed))))


def extract_opera_feature(
    sound_dir_loc: Sequence[str],
    pretrain: str = "operaCE",
    input_sec: float = 8,
    dim: int = 1280,
    pad0: bool = False,
    ckpt_path: Optional[str] = None,
    batch_size: int = 16,
    random_init: bool = False,
    device="cuda",
) -> np.ndarray:
    """Functional API mirroring model_util.extract_opera_feature:113-182
    (the JAX extract.py:628-648)."""
    ex = FeatureExtractor(pretrain, dim=dim, input_sec=input_sec, ckpt_path=ckpt_path, pad0=pad0,
                          batch_size=batch_size, random_init=random_init, device=device)
    return ex.extract_files(list(sound_dir_loc))
