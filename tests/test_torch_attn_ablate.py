"""The TPU attention-half kernels K10 (bench/gt_attn_opt.py::kernel) and K11
(bench/vit_attn_ablate.py::attn_kernel) against the port's vit_attn modes
(ops/vit.py ATTN_MODES, plain versions on the CPU), every mode name of both
files, on the same numpy inputs.

Both root files run full-size benchmarks when imported (and the second
builds CLAP-2023), so the kernel bodies are taken from their source with
`ast` and exec'd beside pallas_swin._ln, then run under
pl.pallas_call(..., interpret=True) at a small shape (B=2, Np=48, C=128, 2
heads of 64, q_chunk 16). The card kernels are checked against the same
plain versions by test_torch_kernels.py."""

import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from heart_murmur_detection_tpu.ops.pallas_swin import _ln
from heart_murmur_detection_tpu_torch.bench import attn_ablate
from heart_murmur_detection_tpu_torch.ops import vit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BODIES = {"gt_attn_opt": "kernel", "vit_attn_ablate": "attn_kernel"}
B, NP, C, HEADS, Q_CHUNK = 2, 48, 128, 2, 16
# Both sides round at the same points (bf16 qkv after its f32 bias, bf16 P
# or e, bf16 head outputs, one rounding of x + proj); the f32 sums run in
# other orders, so a rounding can land one bf16 step apart. max|d| is held to
# 2 bf16 steps at the output's largest magnitude (2 x 2^-7 relative); the
# branch (out - x) to cosine 0.99999.
COS_BAR = 0.99999
ULPS = 2


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _body(file: str):
    """The kernel body of a root bench file, without importing the file."""
    path = os.path.join(ROOT, "bench", file + ".py")
    src = open(path).read()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == BODIES[file])
    ns = {"jax": jax, "jnp": jnp, "_ln": _ln}
    exec(compile(ast.Module([fn], type_ignores=[]), path, "exec"), ns)
    return ns[BODIES[file]]


def _jax_half(file: str, mode: str, x: np.ndarray, w) -> np.ndarray:
    """One attention half through the file's body in interpret mode, with
    the weights in the files' dtypes (matmul weights bf16)."""
    w_qkv, b_qkv, w_proj, b_proj, ln_s, ln_b = w
    args = (jnp.asarray(w_qkv).astype(jnp.bfloat16), jnp.asarray(b_qkv),
            jnp.asarray(w_proj).astype(jnp.bfloat16), jnp.asarray(b_proj), jnp.asarray(ln_s),
            jnp.asarray(ln_b))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    full = lambda a: pl.BlockSpec(a.shape, lambda b: (0,) * a.ndim)
    out = pl.pallas_call(
        functools.partial(_body(file), heads=HEADS, q_chunk=Q_CHUNK, mode=mode),
        out_shape=jax.ShapeDtypeStruct(xb.shape, xb.dtype),
        grid=(x.shape[0],),
        in_specs=[pl.BlockSpec((1,) + x.shape[1:], lambda b: (b, 0, 0))] + [full(a) for a in args],
        out_specs=pl.BlockSpec((1,) + x.shape[1:], lambda b: (b, 0, 0)),
        interpret=True,
    )(xb, *args)
    return np.asarray(out.astype(jnp.float32))


def _case(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, NP, C)).astype(np.float32)
    return x, attn_ablate.draw_weights(rng, C)


def _port_half(mode: str, x: np.ndarray, w, path: str = "half") -> np.ndarray:
    """The port's plain attention half in `mode`: whole (vit_attn_ref), or
    as the two steps the card launches (vit_attn_core_ref, vit_proj_ref)."""
    p = attn_ablate.half_params(w, HEADS)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    if path == "half":
        y = vit.vit_attn_ref(xb, p, mode=mode)
    else:
        y = vit.vit_proj_ref(vit.vit_attn_core_ref(vit.vit_qkv_ref(xb, p), p, mode=mode), xb, p)
    return y.to(torch.float32).numpy()


CASES = [(f, m) for f, names in attn_ablate.FILES.items() for m in names if m != "aligned_hcat"]
_JAX = {}  # (file, name) -> the body's output on _case(1), shared by both paths


@pytest.mark.parametrize("path", ["half", "core_then_proj"])
@pytest.mark.parametrize("file,name", CASES)
def test_mode_matches_tpu_body(file, name, path):
    x, w = _case(1)
    if (file, name) not in _JAX:
        _JAX[file, name] = _jax_half(file, name, x, w)
    want = _JAX[file, name]
    got = _port_half(attn_ablate.JAX_MODES[(file, name)], x, w, path)
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    a, b = (got - xb).ravel().astype(np.float64), (want - xb).ravel().astype(np.float64)
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    err = np.abs(got - want).max()
    assert np.isfinite(got).all()
    assert cos >= COS_BAR, (file, name, cos)
    assert err <= ULPS * step, (file, name, err, step)


def test_modes_differ_where_their_math_differs():
    """The mode map is not vacuous: norm_before, fast, bf16_exp, no_softmax
    and q_passthrough give different halves on one input."""
    x, w = _case(2)
    outs = {m: _port_half(m, x, w) for m in ("norm_before", "fast", "bf16_exp", "no_softmax",
                                             "q_passthrough")}
    names = list(outs)
    for i, m in enumerate(names):
        for n in names[i + 1:]:
            assert not np.array_equal(outs[m], outs[n]), (m, n)


def test_aligned_hcat_raises_in_both():
    """K11's aligned_hcat slices v past 3C at hd 64 with 2 or more heads:
    the JAX body cannot be traced there, and the port raises ValueError."""
    x, w = _case(3)
    with pytest.raises(TypeError, match="[Cc]oncatenate"):
        _jax_half("vit_attn_ablate", "aligned_hcat", x, w)
    with pytest.raises(ValueError, match="aligned_hcat"):
        _port_half("aligned_hcat", x, w)
    with pytest.raises(ValueError):
        vit.aligned_offsets(384, 6, 64)


def test_aligned_hcat_is_norm_before_at_one_head():
    """Where no slice runs past 3C (one head), aligned_hcat is norm_before,
    in the TPU body and in the port."""
    rng = np.random.default_rng(4)
    Cs = 64
    x = rng.standard_normal((B, NP, Cs)).astype(np.float32)
    w = attn_ablate.draw_weights(rng, Cs)
    p = attn_ablate.half_params(w, 1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = vit.vit_attn_ref(xb, p, mode="aligned_hcat")
    assert torch.equal(got, vit.vit_attn_ref(xb, p, mode="norm_before"))
    global HEADS
    heads, HEADS = HEADS, 1
    try:
        want = _jax_half("vit_attn_ablate", "aligned_hcat", x, w)
    finally:
        HEADS = heads
    assert np.abs(got.float().numpy() - want).max() <= ULPS * 2.0 ** (
        np.floor(np.log2(np.abs(want).max())) - 7)


def test_exp_without_max_overflows_as_the_tpu_body():
    """norm_before and fast take no row max: scores past float32's exp range
    give non-finite outputs in the port, as in the TPU body."""
    x, w = _case(5)
    w = (w[0] * 400.0,) + tuple(w[1:])
    want = _jax_half("gt_attn_opt", "v0", x, w)
    got = _port_half("norm_before", x, w)
    assert not np.isfinite(want).all()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))


def test_bench_weights_follow_the_files_draws():
    """attn_ablate draws x, then each mode's six arrays, from
    default_rng(0) in the files' order and scale."""
    x, rng = attn_ablate.inputs("cpu")
    r = np.random.default_rng(0)
    x0 = r.standard_normal((attn_ablate.B, attn_ablate.NP, attn_ablate.C)).astype(np.float32)
    assert torch.equal(x, torch.from_numpy(x0).to(torch.bfloat16))
    w = attn_ablate.draw_weights(rng, attn_ablate.C)
    g = lambda *s: r.standard_normal(s).astype(np.float32) * 0.02
    C = attn_ablate.C
    for got, want in zip(w, (g(C, 3 * C), g(1, 3 * C), g(C, C), g(1, C))):
        np.testing.assert_array_equal(got, want)
    p = attn_ablate.half_params(w, attn_ablate.HEADS)
    # q unscaled: the q rows of the layout are the drawn weights, rounded to bf16
    assert torch.equal(p.w_qkv[:C], torch.from_numpy(w[0].T[:C].copy()).to(torch.bfloat16))
