"""ops/vit.py (the port's ViT block entry points, plain versions on the CPU)
against the JAX Pallas entry points of ops/pallas_vit.py run in interpret
mode (as tests/test_pallas_vit.py runs them), on the same numpy weights and
inputs, plus the weight layout and the CPU dispatch rules. The CUDA kernels
themselves are checked on a card by test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.ops import pallas_vit as pv
from heart_murmur_detection_tpu.ops.pallas_swin import _ln as jax_ln
from heart_murmur_detection_tpu_torch.ops import vit


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the test run shares the cores among its xdist
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the swin tests' f32 bound (test_torch_swin.py), itself the bound of
# test_pallas_swin.py::test_split_block_matches_flax
ATOL, RTOL = 3e-5, 1e-4
# bf16 flow on both sides: the same rounding points, but the JAX body's erf
# is a polynomial and the sums run in other orders, so a few bf16 roundings
# land on the other side
BF16_BRANCH_COS = 0.9999


def _block(C, heads, seed, scale=0.05):
    """One ViT block's weights as a flax param dict and as the port's
    reference-named state_dict."""
    r = np.random.default_rng(seed)
    f = lambda *s: (r.standard_normal(s) * scale).astype(np.float32)
    p = {
        "norm1": {"scale": 1 + f(C), "bias": f(C)},
        "attn_qkv": {"kernel": f(C, 3 * C) * 4, "bias": f(3 * C)},
        "attn_proj": {"kernel": f(C, C), "bias": f(C)},
        "norm2": {"scale": 1 + f(C), "bias": f(C)},
        "mlp_fc1": {"kernel": f(C, 4 * C), "bias": f(4 * C)},
        "mlp_fc2": {"kernel": f(4 * C, C), "bias": f(C)},
    }
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    sd = {}
    for ours, theirs in (("norm1", "norm1"), ("norm2", "norm2")):
        sd[f"{ours}.weight"], sd[f"{ours}.bias"] = t(p[theirs]["scale"]), t(p[theirs]["bias"])
    for ours, theirs in (("attn.qkv", "attn_qkv"), ("attn.proj", "attn_proj"),
                         ("mlp.fc1", "mlp_fc1"), ("mlp.fc2", "mlp_fc2")):
        sd[f"{ours}.weight"] = t(p[theirs]["kernel"].T)
        sd[f"{ours}.bias"] = t(p[theirs]["bias"])
    return p, sd


def _x(B, N, C, seed=0):
    return (np.random.default_rng(seed).standard_normal((B, N, C))).astype(np.float32)


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


C, HEADS = 128, 2  # hd 64, as the kernels take


def _jax_entry(entry, x, p, n_real, fast_softmax, mm_dtype=jnp.float32):
    kw = dict(interpret=True, mm_dtype=mm_dtype)
    if entry == "mlp":
        return pv.fused_vit_mlp(x, p, **kw)
    kw.update(num_heads=HEADS, q_chunk=16, fast_softmax=fast_softmax)
    if entry == "block":
        return pv.fused_vit_block(x, p, n_real, bb=1, **kw)
    return pv.fused_vit_attn(x, p, n_real, **kw)


def _attn_parts(x, p, n_real, fast):
    """The attention half as the card runs it, plain: vit_qkv, then the
    attention core (vit_attn) and proj (vit_proj) as two steps."""
    o = vit.vit_attn_core_ref(vit.vit_qkv_ref(x, p), p, n_real, _MODE[fast])
    return vit.vit_proj_ref(o, x, p)


PORT = {"block": lambda x, p, n_real, fast: vit.fused_vit_block(x, p, n_real, _MODE[fast]),
        "attn": lambda x, p, n_real, fast: vit.fused_vit_attn(x, p, n_real, _MODE[fast]),
        "attn_parts": _attn_parts,
        "mlp": lambda x, p, n_real, fast: vit.fused_vit_mlp(x, p)}
_MODE = {False: "stable", True: "fast"}


@pytest.mark.parametrize("entry", ["block", "attn", "attn_parts", "mlp"])
@pytest.mark.parametrize("fast_softmax", [False, True])
def test_entry_f32_matches_jax(entry, fast_softmax):
    """K5, K6, K7 in float32 with 33 real tokens padded to 48; attn_parts
    is K6 through the two plain steps the card splits it into."""
    p, sd = _block(C, HEADS, seed=3)
    xp, n_real = vit.pad_tokens(torch.from_numpy(_x(2, 33, C, seed=1)), 16)
    assert xp.shape[1] == 48 and n_real == 33
    want = np.asarray(_jax_entry(entry.split("_")[0], jnp.asarray(xp.numpy()), p, n_real,
                                 fast_softmax))
    pb = vit.prep_vit_block(sd, HEADS, torch.float32)
    got = PORT[entry](xp, pb, n_real, fast_softmax)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("entry", ["block", "attn", "attn_parts", "mlp"])
@pytest.mark.parametrize("fast_softmax", [False, True])
def test_entry_bf16_flow_matches_jax(entry, fast_softmax):
    """bf16 activations and matmuls, f32 LN / softmax / GELU on both sides,
    compared on the branch each entry adds to x."""
    p, sd = _block(C, HEADS, seed=5)
    xp, n_real = vit.pad_tokens(torch.from_numpy(_x(2, 40, C, seed=2)), 16)
    xb = xp.to(torch.bfloat16)
    xj = jnp.asarray(xp.numpy()).astype(jnp.bfloat16)
    want = np.asarray(_jax_entry(entry.split("_")[0], xj, p, n_real, fast_softmax, jnp.bfloat16),
                      np.float32)
    pb = vit.prep_vit_block(sd, HEADS, torch.bfloat16)
    got = PORT[entry](xb, pb, n_real, fast_softmax)
    assert got.dtype == torch.bfloat16
    base = xb.float().numpy()
    assert _cos(got.float().numpy()[:, :n_real] - base[:, :n_real],
                want[:, :n_real] - base[:, :n_real]) >= BF16_BRANCH_COS


def test_padded_columns_do_not_leak():
    """Same real tokens, different pad amounts and pad contents -> the same
    real rows (the plain version masks keys >= n_real)."""
    _, sd = _block(C, HEADS, seed=7)
    pb = vit.prep_vit_block(sd, HEADS, torch.float32)
    x = torch.from_numpy(_x(1, 17, C, seed=3))
    a = vit.fused_vit_block(vit.pad_tokens(x, 16)[0], pb, 17)[:, :17]
    x64 = torch.nn.functional.pad(x, (0, 0, 0, 64 - 17), value=5.0)
    b = vit.fused_vit_block(x64, pb, 17)[:, :17]
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


def test_pad_tokens_matches_jax():
    x = _x(2, 33, 8)
    jp, jn = pv.pad_tokens(jnp.asarray(x), 16)
    tp, tn = vit.pad_tokens(torch.from_numpy(x), 16)
    assert jn == tn == 33
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16])
def test_prep_folds_the_q_scale_as_jax(mm_dtype):
    """q rows and q bias scaled by hd^-0.5 in f32 before the cast, exactly
    as pallas_vit._attn_weights; the rest keep the torch (out, in) layout."""
    p, sd = _block(C, HEADS, seed=9)
    jdt = jnp.float32 if mm_dtype == torch.float32 else jnp.bfloat16
    w_qkv, b_qkv, w_proj, b_proj, s1, b1 = pv._attn_weights(p, jdt, HEADS)
    pb = vit.prep_vit_block(sd, HEADS, mm_dtype)
    np.testing.assert_array_equal(pb.w_qkv.float().numpy().T, np.asarray(w_qkv, np.float32))
    np.testing.assert_array_equal(pb.b_qkv.numpy(), np.asarray(b_qkv).reshape(-1))
    np.testing.assert_array_equal(pb.w_proj.float().numpy().T, np.asarray(w_proj, np.float32))
    assert pb.w_qkv.dtype == mm_dtype and pb.b_qkv.dtype == torch.float32
    assert (pb.heads, pb.hd, pb.hidden) == (HEADS, 64, 4 * C)


def test_qkv_is_head_major():
    """vit_qkv_ref writes (3, B, heads, Np, hd): head h of q is columns
    h*hd..(h+1)*hd of the q third."""
    _, sd = _block(C, HEADS, seed=11)
    pb = vit.prep_vit_block(sd, HEADS, torch.float32)
    x = torch.from_numpy(_x(2, 16, C, seed=4))
    qkv = vit.vit_qkv_ref(x, pb)
    assert qkv.shape == (3, 2, HEADS, 16, 64)
    h = vit._ln(x, pb.ln1_w, pb.ln1_b, vit.LN_EPS)
    flat = h @ pb.w_qkv.T + pb.b_qkv
    np.testing.assert_allclose(qkv[1, :, 1].numpy(), flat[..., C + 64 : C + 128].numpy(),
                               atol=1e-6)


def test_cpu_tensors_never_reach_the_library():
    """A CPU tensor runs the plain version: no build, no launch."""
    _, sd = _block(C, HEADS, seed=13)
    pb = vit.prep_vit_block(sd, HEADS, torch.bfloat16)
    x = torch.from_numpy(_x(1, 32, C, seed=5)).to(torch.bfloat16)
    before = vit.launch_counts()
    qkv = vit.vit_qkv(x, pb)
    assert torch.equal(qkv, vit.vit_qkv_ref(x, pb))
    o = vit.vit_attn(qkv, pb, 30, "fast")
    assert torch.equal(o, vit.vit_attn_core_ref(qkv, pb, 30, "fast"))
    assert torch.equal(vit.vit_proj(o, x, pb), vit.vit_attn_out_ref(x, qkv, pb, 30, "fast"))
    assert torch.equal(vit.vit_mlp(x, pb), vit.vit_mlp_ref(x, pb))
    assert vit.launch_counts() == before
    with pytest.raises(ValueError):
        vit.fused_vit_block(x, pb, 30, impl="pallas")


def test_cuda_checks_refuse_unpadded_tokens():
    """The attention kernels take tokens padded to a multiple of 16
    (pad_tokens, as the JAX entry points pad them): the wrapper's check
    refuses other lengths before any launch, and passes padded ones."""
    _, sd = _block(C, HEADS, seed=23)
    pb = vit.prep_vit_block(sd, HEADS, torch.bfloat16)
    big = vit.prep_vit_block(_block(384, 6, seed=23)[1], 6, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        vit._check_cuda_args(torch.zeros(2, 40, 384, dtype=torch.bfloat16), big, attn=True)
    vit._check_cuda_args(torch.zeros(2, 48, 384, dtype=torch.bfloat16), big, attn=True)
    xp, n_real = vit.pad_tokens(torch.zeros(2, 40, 384), 16)
    assert xp.shape[1] % 16 == 0 and n_real == 40
    assert np.asarray(pv.pad_tokens(jnp.zeros((2, 40, 384)), 16)[0]).shape == tuple(xp.shape)
    with pytest.raises(ValueError, match="C 384 or 768"):  # the width rule stays first
        vit._check_cuda_args(torch.zeros(2, 40, C, dtype=torch.bfloat16), pb, attn=True)


@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16])
def test_vit_qkv_ln1_output_matches_jax(mm_dtype):
    """vit_qkv(..., return_ln=True) on the plain path: the same q, k, v as
    vit_qkv_ref and LN1(x) as (B Np, C) rows, against the JAX body's LN1
    (`_attn_half`: _ln with eps 1e-6, cast to the activation dtype), with 37
    real tokens padded to 48."""
    p, sd = _block(C, HEADS, seed=19)
    pb = vit.prep_vit_block(sd, HEADS, mm_dtype)
    xp, _ = vit.pad_tokens(torch.from_numpy(_x(2, 37, C, seed=8)), 16)
    x = xp.to(mm_dtype)
    qkv, h = vit.vit_qkv(x, pb, return_ln=True)
    assert torch.equal(qkv, vit.vit_qkv_ref(x, pb)) and torch.equal(qkv, vit.vit_qkv(x, pb))
    assert h.shape == (2 * 48, C) and h.dtype == x.dtype
    act = jnp.bfloat16 if mm_dtype == torch.bfloat16 else jnp.float32
    want = jax_ln(jnp.asarray(xp.numpy()).astype(act), jnp.asarray(p["norm1"]["scale"]),
                  jnp.asarray(p["norm1"]["bias"]), eps=1e-6).astype(act)
    want = np.asarray(want.astype(jnp.float32)).reshape(-1, C)
    if mm_dtype == torch.float32:
        np.testing.assert_allclose(h.numpy(), want, atol=ATOL, rtol=RTOL)
    else:
        assert _cos(h.float().numpy(), want) >= 0.99999


@pytest.mark.parametrize("mm_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", vit.ATTN_MODES[:6])
def test_core_then_proj_is_the_attention_half(mode, mm_dtype):
    """The two plain steps the card launches, vit_attn_core_ref (each head's
    output rounded into its column block) then vit_proj_ref, are bitwise
    the plain attention half vit_attn_out_ref, in every mode, with padded
    keys masked."""
    _, sd = _block(C, HEADS, seed=17)
    pb = vit.prep_vit_block(sd, HEADS, mm_dtype)
    xp, n_real = vit.pad_tokens(torch.from_numpy(_x(2, 37, C, seed=7)), 16)
    x = xp.to(mm_dtype)
    qkv = vit.vit_qkv_ref(x, pb)
    o = vit.vit_attn_core_ref(qkv, pb, n_real, mode)
    assert o.shape == x.shape and o.dtype == x.dtype
    assert torch.equal(vit.vit_proj_ref(o, x, pb), vit.vit_attn_out_ref(x, qkv, pb, n_real, mode))
