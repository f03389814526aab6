"""The HeAR slice of the port (audio/hear_frontend.py, models/hear.py,
models/vit_fused.py::hear_forward_fused, extract/convert.py's HeAR loaders,
extract_and_save's hear branch) against the JAX package on the same numpy
inputs and weights: the mel-PCEN frontend, a narrow HeAR tower on its strict
float32 path and on the plain bf16 flow, one ViT block at HeAR's own
geometry against the TPU kernels K6 / K7 in interpret mode, the weight
loaders, and the extraction entry point. The CUDA kernels at this geometry are
checked on a card by test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.audio import hear_frontend as jfront
from heart_murmur_detection_tpu.extract.convert import convert_hear_vit
from heart_murmur_detection_tpu.models import hear as jhear
from heart_murmur_detection_tpu.models import vit_fused as jfused
from heart_murmur_detection_tpu.ops import pallas_vit as pv
from heart_murmur_detection_tpu.utils.audio_io import load_wav as jload_wav
from heart_murmur_detection_tpu_torch.audio import hear_frontend as front
from heart_murmur_detection_tpu_torch.data.processors.common import extract_and_save
from heart_murmur_detection_tpu_torch.extract import convert
from heart_murmur_detection_tpu_torch.models import hear
from heart_murmur_detection_tpu_torch.models.vit_fused import hear_forward_fused
from heart_murmur_detection_tpu_torch.ops import vit
from heart_murmur_detection_tpu_torch.utils.audio_io import write_wav

# the JAX package's own bound for the fused HeAR against flax
# (tests/test_fused_zoo.py::TestHeARFused)
ATOL, RTOL = 2e-5, 1e-4
# the bf16 flow on both sides (the same rounding points; the sums run in
# other orders and JAX's erf is a polynomial)
BF16_COS = 0.99999
# one block's branch in the bf16 flow (tests/test_torch_swin_plan.py's bar)
BLOCK_BF16_COS = 0.99995
# the narrow tower of tests/test_fused_zoo.py::TestHeARFused
TINY = dict(image_size=(32, 32), patch_size=16, hidden=64, depth=2, heads=2, mlp_ratio=4.0,
            pooled_dim=8)
# the same width over the real (192, 128) frontend, one block
WAVE = dict(TINY, image_size=(192, 128), depth=1)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the test run shares the cores among its xdist
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cos(a, b) -> float:
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _waves():
    """A clip shorter than 2 s, a constant clip and a noisy one (32000
    samples each; the short one zero-padded, as hear_preprocess pads)."""
    r = np.random.default_rng(12)
    t = np.arange(32000) / 16000
    short = np.zeros(32000, np.float32)
    short[:20000] = 0.3 * np.sin(2 * np.pi * 220 * t[:20000])
    const = np.full(32000, 0.25, np.float32)
    noisy = (0.1 * r.standard_normal(32000) + 0.5 * np.sin(2 * np.pi * 90 * t)).astype(np.float32)
    return np.stack([short, const, noisy]), short[:20000]


# ---------------------------------------------------------------------------
# the frontend
# ---------------------------------------------------------------------------


def _preprocess_f64(x: np.ndarray) -> np.ndarray:
    """The frontend's function in float64 numpy, the tables built in
    float64 (the mel matrix as the JAX module casts it)."""
    x = x.astype(np.float64)
    x = x - x.min(1, keepdims=True)
    x = x / (x.max(1, keepdims=True) + 1e-8) * 2.0 - 1.0
    x = np.pad(x, ((0, 0), (0, 160 * 199 + 400 - x.shape[1])))
    frames = np.stack([x[:, 160 * t: 160 * t + 400] for t in range(200)], 1)
    n, k = np.arange(400), np.arange(201)
    ang = 2 * np.pi * np.outer(n, k) / 400
    w = (0.5 - 0.5 * np.cos(2 * np.pi * n / 400))[:, None]
    power = (frames @ (np.cos(ang) * w)) ** 2 + (frames @ (np.sin(ang) * w)) ** 2
    mel = power @ jfront.tf_mel_matrix().astype(np.float64)
    t, j = np.arange(200)[:, None], np.arange(200)[None, :]
    A = np.where(j <= t, 0.04 * 0.96 ** (t - j), 0.0)
    A[:, 0] = 0.96 ** np.arange(200)
    out = (mel / (1e-8 + A @ mel) ** 0.8 + 2.0) ** 0.5 - 2.0 ** 0.5
    return jfront._resize_matrix(200, 192).astype(np.float64) @ out


def test_preprocess_matches_jax():
    """hear_preprocess on a short, a constant and a noisy clip against the
    JAX frontend at Precision.HIGHEST and against the function in float64.

    The noisy clip reads within 2e-5 of the output's range of JAX. Where a
    clip holds a constant stretch (the constant clip; the zero padding of
    the short one), its frames' DFT bins that are 0 in exact arithmetic
    hold float32 rounding noise (power ~1e-9), and PCEN lifts that noise
    near its floor: there the JAX frontend itself is 2.9e-5 and 1.2e-4 of
    the range from the float64 function. So for every clip the port is
    held to no more than JAX's own float32 error against float64, and to
    twice that against JAX. A clip under 2 s gives what its zero-padded
    copy gives."""
    x, short = _waves()
    want = np.asarray(jfront.hear_preprocess(jnp.asarray(x)))
    got = front.hear_preprocess(torch.from_numpy(x)).numpy()
    exact = _preprocess_f64(x)
    assert got.shape == want.shape == exact.shape == (3, 192, 128)
    for i in range(3):
        span = float(exact[i].max() - exact[i].min())
        err_jax = np.abs(want[i] - exact[i]).max()
        assert np.abs(got[i] - exact[i]).max() <= max(err_jax, 2e-5 * span), i
        assert np.abs(got[i] - want[i]).max() <= max(2 * err_jax, 2e-5 * span), i
    assert np.abs(got[2] - want[2]).max() <= 2e-5 * float(want[2].max() - want[2].min())
    alone = front.hear_preprocess(torch.from_numpy(short[None])).numpy()
    np.testing.assert_array_equal(alone[0], got[0])


@pytest.mark.parametrize("impl", ["matmul", "scan"])
def test_pcen_matches_jax(impl):
    """pcen's triangular product and its literal recurrence, each against
    the JAX form of the same name, within 1e-6 relative."""
    E = np.abs(np.random.default_rng(2).standard_normal((3, 200, 128))).astype(np.float32)
    want = np.asarray(jfront.pcen(jnp.asarray(E), impl=impl))
    got = front.pcen(torch.from_numpy(E), impl=impl).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("impl", ["matmul", "gather"])
@pytest.mark.parametrize("out_hw", [(192, 128), (96, 64)])
def test_resize_matches_jax(impl, out_hw):
    x = np.random.default_rng(3).standard_normal((2, 200, 128)).astype(np.float32)
    want = np.asarray(jfront.resize_bilinear_tf(jnp.asarray(x), *out_hw, impl=impl))
    got = front.resize_bilinear_tf(torch.from_numpy(x), *out_hw, impl=impl).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_tables_match_jax():
    np.testing.assert_array_equal(front.tf_mel_matrix(), jfront.tf_mel_matrix())
    for a, b in zip(front._dft(400), jfront._dft(400)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(front._ema_matrix(200, 0.04), jfront._ema_matrix(200, 0.04))


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------


def _jax_tower(cfg: dict, B: int, seed: int):
    """A flax HeAREncoder at `cfg` with its variables, the port's model
    carrying the same weights (from_jax_hear), and an input of B clips (a
    spectrogram for a 32 x 32 image, else waveforms)."""
    jcfg = jhear.HeARConfig(**cfg)
    model = jhear.HeAREncoder(jcfg)
    r = np.random.default_rng(seed)
    if cfg["image_size"] == (32, 32):
        x = r.standard_normal((B, 32, 32)).astype(np.float32)
        init_in, spec = jnp.zeros((1, 32, 32)), True
    else:
        x = (0.2 * r.standard_normal((B, 32000))).astype(np.float32)
        init_in, spec = jnp.zeros((1, 32000)), False
    v = jax.jit(lambda k: model.init(k, init_in, False, spec))(jax.random.PRNGKey(seed))
    v = jax.tree.map(np.asarray, v)
    ours = hear.HeAREncoder(hear.HeARConfig(**cfg))
    ours.load_state_dict(convert.from_jax_hear(v))
    return jcfg, model, v, ours.eval(), x, spec


@pytest.fixture(scope="module")
def tiny():
    return _jax_tower(TINY, 2, seed=0)


def test_strict_f32_matches_flax_and_jax_fused(tiny):
    """The port's forward and its f32 hear_forward_fused against flax
    apply(...)["pooled"] and the JAX hear_forward_fused (f32, interpret
    mode), at the JAX file's own tolerance."""
    jcfg, model, v, ours, x, spec = tiny
    flax_out = np.asarray(model.apply(v, jnp.asarray(x), from_spectrogram=True)["pooled"])
    jax_fused = np.asarray(jfused.hear_forward_fused(
        v, jnp.asarray(x), jcfg, mm_dtype=jnp.float32, interpret=True, from_spectrogram=True))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        fwd = ours(xt, from_spectrogram=True)
    fused = hear_forward_fused(ours, xt, mm_dtype=torch.float32, from_spectrogram=True)
    for got in (fwd["pooled"].numpy(), fused.numpy()):
        np.testing.assert_allclose(got, flax_out, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got, jax_fused, atol=ATOL, rtol=RTOL)
    want = model.apply(v, jnp.asarray(x), from_spectrogram=True)
    np.testing.assert_allclose(fwd["cls"].numpy(), np.asarray(want["cls"]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(fwd["tokens"].numpy(), np.asarray(want["tokens"]), atol=ATOL,
                               rtol=RTOL)


def test_waveform_path_matches_flax():
    """One block over the real frontend: waveforms through the port's
    forward and f32 hear_forward_fused against flax apply."""
    _, model, v, ours, x, _ = _jax_tower(WAVE, 2, seed=1)
    want = np.asarray(jax.jit(lambda a: model.apply(v, a)["pooled"])(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = ours(xt)["pooled"].numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    fused = hear_forward_fused(ours, xt, mm_dtype=torch.float32).numpy()
    np.testing.assert_allclose(fused, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fast_softmax", [False, True])
def test_bf16_flow_matches_jax_fused(tiny, fast_softmax):
    """The plain bf16 flow (the kernels' plain versions on the CPU) against
    the JAX bf16 hear_forward_fused in interpret mode: cosine >= 0.99999
    (it reads 0.9999999 or closer)."""
    jcfg, _, v, ours, x, _ = tiny
    want = np.asarray(jfused.hear_forward_fused(
        v, jnp.asarray(x), jcfg, mm_dtype=jnp.bfloat16, interpret=True, from_spectrogram=True,
        fast_softmax=fast_softmax))
    got = hear_forward_fused(ours, torch.from_numpy(x), mm_dtype=torch.bfloat16,
                             fast_softmax=fast_softmax, from_spectrogram=True).numpy()
    assert _cos(got, want) >= BF16_COS


# ---------------------------------------------------------------------------
# one block at HeAR's geometry (ViT-L: C 1024, 16 heads, hidden 4096, 97
# tokens padded to 112), plain versions against the TPU kernels K6 / K7
# ---------------------------------------------------------------------------

C_L, HEADS_L, NP_L, NREAL_L = 1024, 16, 112, 97


@pytest.fixture(scope="module")
def vit_l_block():
    r = np.random.default_rng(24)
    f = lambda *s: (r.standard_normal(s) * 0.03).astype(np.float32)
    C = C_L
    p = {"norm1": {"scale": 1 + f(C), "bias": f(C)},
         "attn_qkv": {"kernel": f(C, 3 * C), "bias": f(3 * C)},
         "attn_proj": {"kernel": f(C, C), "bias": f(C)},
         "norm2": {"scale": 1 + f(C), "bias": f(C)},
         "mlp_fc1": {"kernel": f(C, 4 * C), "bias": f(4 * C)},
         "mlp_fc2": {"kernel": f(4 * C, C), "bias": f(C)}}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    sd = {}
    for n in ("norm1", "norm2"):
        sd[f"{n}.weight"], sd[f"{n}.bias"] = t(p[n]["scale"]), t(p[n]["bias"])
    for ours, theirs in (("attn.qkv", "attn_qkv"), ("attn.proj", "attn_proj"),
                         ("mlp.fc1", "mlp_fc1"), ("mlp.fc2", "mlp_fc2")):
        sd[f"{ours}.weight"], sd[f"{ours}.bias"] = t(p[theirs]["kernel"].T), t(p[theirs]["bias"])
    x = r.standard_normal((1, NP_L, C)).astype(np.float32)
    x[:, NREAL_L:] = 0.0  # the padded rows of pad_tokens
    return p, sd, x


@pytest.mark.parametrize("mode", ["stable", "fast"])
@pytest.mark.parametrize("bf16", [False, True])
def test_vit_l_block_matches_jax_kernels(vit_l_block, mode, bf16):
    """vit_qkv_ref, vit_attn_core_ref, vit_proj_ref and vit_mlp_ref chained
    (the plain versions of the four kernels at C 1024) against JAX
    fused_vit_attn (K6) then fused_vit_mlp (K7) in interpret mode, the
    padded keys masked: float32 at 1e-4 on the real rows, the bf16 flow on
    each half's branch at 0.99995."""
    p, sd, x = vit_l_block
    mm, jmm = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32, jnp.float32)
    xj = jnp.asarray(x).astype(jmm)
    h1_want = pv.fused_vit_attn(xj, p, NREAL_L, num_heads=HEADS_L, mm_dtype=jmm,
                                fast_softmax=mode == "fast", interpret=True)
    y_want = np.asarray(pv.fused_vit_mlp(h1_want, p, mm_dtype=jmm, interpret=True), np.float32)
    h1_want = np.asarray(h1_want, np.float32)
    pb = vit.prep_vit_block(sd, HEADS_L, mm)
    xt = torch.from_numpy(x).to(mm)
    qkv = vit.vit_qkv_ref(xt, pb)
    assert qkv.shape == (3, 1, HEADS_L, NP_L, 64)
    o = vit.vit_attn_core_ref(qkv, pb, NREAL_L, mode)
    h1 = vit.vit_proj_ref(o, xt, pb)
    # K7 on the JAX half's output, so each half is compared alone
    y = vit.vit_mlp_ref(torch.tensor(h1_want).to(mm), pb).float().numpy()
    h1 = h1.float().numpy()
    real = slice(0, NREAL_L)
    if bf16:
        base = np.asarray(xj, np.float32)
        assert _cos((h1 - base)[:, real], (h1_want - base)[:, real]) >= BLOCK_BF16_COS
        assert _cos((y - h1_want)[:, real], (y_want - h1_want)[:, real]) >= BLOCK_BF16_COS
    else:
        np.testing.assert_allclose(h1[:, real], h1_want[:, real], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(y[:, real], y_want[:, real], atol=1e-4, rtol=1e-4)


def test_vit_l_geometry_passes_the_cuda_checks(vit_l_block):
    """C 1024 with 16 heads of 64 passes the attention and MLP kernels'
    argument checks (no launch on the CPU); the training backward kernels
    (C 384 and 768) and other widths still raise before any launch."""
    from heart_murmur_detection_tpu_torch.ops import vit_train

    _, sd, _ = vit_l_block
    pb = vit.prep_vit_block(sd, HEADS_L, torch.bfloat16)
    x = torch.zeros(2, NP_L, C_L, dtype=torch.bfloat16)
    vit._check_cuda_args(x, pb, attn=True)
    vit._check_cuda_args(x, pb, attn=False)
    with pytest.raises(ValueError, match="backward"):
        vit_train._check_bwd_args(x, x, pb)
    p960 = vit.prep_vit_block(_width(sd, 960), 15, torch.bfloat16)
    x960 = torch.zeros(2, NP_L, 960, dtype=torch.bfloat16)
    for attn in (True, False):
        with pytest.raises(ValueError, match="1024"):
            vit._check_cuda_args(x960, p960, attn=attn)


def _width(sd, C):
    """The block's weights cut to width C (shapes only matter)."""
    out = {}
    for k, v in sd.items():
        if k.endswith("qkv.weight"):
            out[k] = v[: 3 * C, :C]
        elif k.endswith("qkv.bias"):
            out[k] = v[: 3 * C]
        elif k.endswith("fc1.weight"):
            out[k] = v[: 4 * C, :C]
        elif k.endswith("fc1.bias"):
            out[k] = v[: 4 * C]
        elif k.endswith("fc2.weight"):
            out[k] = v[:C, : 4 * C]
        elif k.endswith("proj.weight"):
            out[k] = v[:C, :C]
        else:
            out[k] = v[:C]
    return out


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def test_from_jax_hear_is_exact(tiny):
    """Every flax leaf lands in one port tensor, exactly (Dense kernels
    transposed, the conv kernel HWIO -> OIHW), and the port's state_dict
    holds nothing else."""
    _, _, v, ours, _, _ = tiny
    sd = ours.state_dict()
    params = v["params"]
    seen = set()

    def check(key, want):
        np.testing.assert_array_equal(sd[key].numpy(), want)
        seen.add(key)

    check("cls_token", params["cls_token"])
    check("pos_embed", params["pos_embed"])
    check("patch_embed.proj.weight", params["patch_embed_proj"]["kernel"].transpose(3, 2, 0, 1))
    check("patch_embed.proj.bias", params["patch_embed_proj"]["bias"])
    for name in ("norm",):
        check(f"{name}.weight", params[name]["scale"])
        check(f"{name}.bias", params[name]["bias"])
    check("pooler.weight", params["pooler"]["kernel"].T)
    check("pooler.bias", params["pooler"]["bias"])
    for i in range(TINY["depth"]):
        blk = params[f"blocks_{i}"]
        for ours_n, theirs in (("norm1", "norm1"), ("norm2", "norm2")):
            check(f"blocks.{i}.{ours_n}.weight", blk[theirs]["scale"])
            check(f"blocks.{i}.{ours_n}.bias", blk[theirs]["bias"])
        for ours_n, theirs in (("attn.qkv", "attn_qkv"), ("attn.proj", "attn_proj"),
                               ("mlp.fc1", "mlp_fc1"), ("mlp.fc2", "mlp_fc2")):
            check(f"blocks.{i}.{ours_n}.weight", blk[theirs]["kernel"].T)
            check(f"blocks.{i}.{ours_n}.bias", blk[theirs]["bias"])
    assert seen == set(sd)


def _hf_state_dict(cfg: dict, seed: int, prefix: str = ""):
    """A synthetic google/hear-pytorch (HF ViTModel) state_dict at `cfg`."""
    r = np.random.default_rng(seed)
    D, p = cfg["hidden"], cfg["patch_size"]
    n = (cfg["image_size"][0] // p) * (cfg["image_size"][1] // p)
    f = lambda *s: (r.standard_normal(s) * 0.1).astype(np.float32)
    sd = {"embeddings.cls_token": f(1, 1, D), "embeddings.position_embeddings": f(1, n + 1, D),
          "embeddings.patch_embeddings.projection.weight": f(D, 1, p, p),
          "embeddings.patch_embeddings.projection.bias": f(D),
          "layernorm.weight": 1 + f(D), "layernorm.bias": f(D),
          "pooler.dense.weight": f(cfg["pooled_dim"], D), "pooler.dense.bias": f(cfg["pooled_dim"])}
    H = int(D * cfg["mlp_ratio"])
    for i in range(cfg["depth"]):
        tp = f"encoder.layer.{i}."
        for n_ in ("query", "key", "value"):
            sd[f"{tp}attention.attention.{n_}.weight"] = f(D, D)
            sd[f"{tp}attention.attention.{n_}.bias"] = f(D)
        sd[tp + "attention.output.dense.weight"], sd[tp + "attention.output.dense.bias"] = f(D, D), f(D)
        sd[tp + "intermediate.dense.weight"], sd[tp + "intermediate.dense.bias"] = f(H, D), f(H)
        sd[tp + "output.dense.weight"], sd[tp + "output.dense.bias"] = f(D, H), f(D)
        for ln in ("layernorm_before", "layernorm_after"):
            sd[f"{tp}{ln}.weight"], sd[f"{tp}{ln}.bias"] = 1 + f(D), f(D)
    return {prefix + k: v for k, v in sd.items()}


def test_load_hear_ckpt_matches_convert_hear_vit(tmp_path):
    """An HF-keyed state_dict (under a "vit." prefix, from a file) through
    load_hear_ckpt gives the forward that the JAX convert_hear_vit's
    variables give flax; a missing key raises."""
    sd = _hf_state_dict(TINY, seed=5)
    jv = convert_hear_vit(sd, depth=TINY["depth"])
    model = jhear.HeAREncoder(jhear.HeARConfig(**TINY))
    x = np.random.default_rng(6).standard_normal((2, 32, 32)).astype(np.float32)
    want = np.asarray(model.apply(jv, jnp.asarray(x), from_spectrogram=True)["pooled"])
    path = tmp_path / "hear.bin"
    torch.save({"vit." + k: torch.from_numpy(v) for k, v in sd.items()}, path)
    ours = convert.load_hear_ckpt(str(path), hear.HeAREncoder(hear.HeARConfig(**TINY))).eval()
    with torch.no_grad():
        got = ours(torch.from_numpy(x), from_spectrogram=True)["pooled"].numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    del sd["encoder.layer.1.attention.attention.key.bias"]
    with pytest.raises(KeyError, match="lacks"):
        convert.load_hear_ckpt(sd, hear.HeAREncoder(hear.HeARConfig(**TINY)))


# ---------------------------------------------------------------------------
# the extraction entry point (extract_and_save)
# ---------------------------------------------------------------------------


def test_extract_and_save_hear_matches_jax(tmp_path, monkeypatch):
    """extract_and_save(pretrain="hear", device="cpu") on three WAVs (one at
    4 kHz, one shorter and one longer than 2 s), batches of 2 so the last is
    filled with copies, against flax apply on the clips loaded by the JAX
    policy (load_wav at 16 kHz, trim or zero-pad to 32000), at the narrow
    width over the real frontend. It writes hear_feature.npy."""
    _, model, v, _, _, _ = _jax_tower(WAVE, 1, seed=3)
    r = np.random.default_rng(7)
    files = []
    for name, sr, sec in (("a.wav", 16000, 3.0), ("b.wav", 4000, 1.5), ("c.wav", 16000, 2.0)):
        y = (0.3 * r.standard_normal(int(sr * sec))).astype(np.float32)
        write_wav(str(tmp_path / name), y, sr)
        files.append(str(tmp_path / name))
    np.save(tmp_path / "sound_dir_loc.npy", np.array(files))
    monkeypatch.setattr(hear, "HeARConfig", lambda: jhear.HeARConfig(**WAVE))
    monkeypatch.setattr(hear, "init_weights",
                        lambda m, g: m.load_state_dict(convert.from_jax_hear(v)))
    out = extract_and_save(str(tmp_path), "hear", input_sec=8, random_init=True, batch_size=2,
                           device="cpu")
    assert out.endswith("hear_feature.npy")
    got = np.load(out)
    clips = []
    for f in files:
        y, _ = jload_wav(f, sr=16000)
        clips.append(y[:32000] if len(y) > 32000 else np.pad(y, (0, 32000 - len(y))))
    want = np.asarray(jax.jit(lambda a: model.apply(v, a)["pooled"])(jnp.asarray(np.stack(clips))))
    assert got.shape == (3, WAVE["pooled_dim"])
    # the clips that fill 2 s at the f32 bound; the padded one carries the
    # frontend's rounding noise of its zero tail (test_preprocess_matches_jax)
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], atol=ATOL, rtol=RTOL)
    assert _cos(got[1], want[1]) >= 0.9999999


def test_cli_process_then_linear_eval_hear_on_cpu(tmp_path, monkeypatch):
    """pretrain=hear end to end on the CPU at the narrow width: cli.process
    writes hear_feature.npy (input_sec plays no part), cli.linear_eval runs
    the seed protocol on it (2 seeds here), and the JAX package's probe
    reads the same file."""
    from heart_murmur_detection_tpu.train.linear_eval import linear_evaluation_heart
    from heart_murmur_detection_tpu_torch.cli import linear_eval, process

    from .test_torch_process import _circor_corpus

    _circor_corpus(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(hear, "HeARConfig", lambda: jhear.HeARConfig(**WAVE))
    (out,) = process.main(["dataset=circor", "pretrain=hear", "random_init=True", "device=cpu"])
    assert out == "feature/circor_eval/hear_feature.npy"
    feats = np.load(out)
    assert feats.shape == (12, WAVE["pooled_dim"]) and np.isfinite(feats).all()
    ((s0, s1),) = linear_eval.main(["task=circor_murmurs", "pretrain=hear", "n_run=2",
                                    "device=cpu"])
    assert np.isfinite([s0, s1]).all() and 0 <= min(s0, s1) <= max(s0, s1) <= 1
    res = linear_evaluation_heart(seed=0, use_feature="hear", loss="weighted",
                                  feature_dir="feature/circor_eval/", labels_filename="murmurs.npy")
    assert np.isfinite(res.test_auc)


@pytest.mark.parametrize("pretrain", ["vggish", "clap", "clap2023", "opensmile"])
def test_other_baselines_still_raise(tmp_path, pretrain):
    """With neither weights nor random_init, the CLAP towers
    (tests/test_torch_clap.py) and VGGish (tests/test_torch_vggish.py) raise
    for want of a checkpoint; opensmile (tests/test_torch_emobase.py) needs
    no weights and raises for the missing file."""
    np.save(tmp_path / "sound_dir_loc.npy", np.array([str(tmp_path / "x.wav")]))
    match = {"vggish": "VGGish weights", "opensmile": "x.wav"}.get(pretrain, "msclap")
    with pytest.raises(FileNotFoundError, match=match):
        extract_and_save(str(tmp_path), pretrain, device="cpu")


def test_hear_without_weights_or_card_raises(tmp_path):
    """No checkpoint and no random_init: FileNotFoundError; device cuda
    without a card: RuntimeError before any model is built."""
    with pytest.raises(FileNotFoundError):
        hear.extract_hear_feature([], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            hear.extract_hear_feature([], random_init=True, device="cuda")
