"""Data-parallel extraction and the entry points, on gloo ranks spawned on
the CPU: operaCT extraction at world 2 against the unsharded port and the
JAX FeatureExtractor on a 2-device mesh (tests/test_parallel.py:130's bars);
extract_and_save written by rank 0 alone; cli.pretrain and cli.finetune
with dp=2 end to end; the dry run of both CP families
(parallel/dryrun.py). The two extraction cases share one launch."""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.extract.extract import FeatureExtractor as JFeatureExtractor
from heart_murmur_detection_tpu.parallel.mesh import data_parallel_mesh, put_replicated
from heart_murmur_detection_tpu_torch.data.processors.common import extract_and_save
from heart_murmur_detection_tpu_torch.extract import convert
from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor
from heart_murmur_detection_tpu_torch.parallel import launch
from tests import torch_parallel_ranks as R
from tests.test_torch_extract import _wav


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads in the test process (the ranks take one each):
    the test run shares the cores among its xdist workers (see
    test_torch_swin.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


EXTRACTOR = "heart_murmur_detection_tpu_torch.extract.extract:FeatureExtractor"


@pytest.fixture(scope="module")
def extraction(tmp_path_factory):
    """3 WAVs of 6-12 s, the JAX extractor on a 2-device mesh, the port on
    one device and extract_and_save's one-device features, and from one
    launch of two ranks: the ranks' features and saved file, and the
    message of the indivisible batch's refusal."""
    tmp = tmp_path_factory.mktemp("extract")
    paths = [_wav(str(tmp / f"c{i}.wav"), 6.0 + 3 * i, 80 + 10 * i) for i in range(3)]
    kw = dict(dim=768, input_sec=8, batch_size=2, random_init=True)
    jex = JFeatureExtractor("operaCT", **kw, compute_dtype=jnp.float32, use_fused_htsat=False)
    state = convert.from_jax(jax.device_get(jex.variables))
    pkw = dict(kw, compute_dtype=torch.float32, device="cpu")
    fdir = tmp / "feature"
    os.makedirs(fdir)
    np.save(fdir / "sound_dir_loc.npy", np.asarray(paths))
    cases = {"rows": ("extract_rank", dict(state=state, paths=paths, fdir=str(fdir), kw=pkw)),
             "odd": ("call", dict(target=EXTRACTOR, expect="ValueError", kwargs=dict(
                 pretrain="operaCT", dim=768, batch_size=3, random_init=True, device="cpu")))}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, R.cases, 2, cases, device="cpu")
        jmesh = JFeatureExtractor("operaCT", **kw, compute_dtype=jnp.float32,
                                  use_fused_htsat=False, mesh=data_parallel_mesh(2))
        jmesh.variables = put_replicated(jax.device_get(jex.variables), jmesh.mesh)
        jmesh._fn = jmesh._build()
        want = jmesh.extract_files(paths)
        one = FeatureExtractor("operaCT", **pkw)
        one.model.load_state_dict(state)
        single = one.extract_files(paths)
        out = ranks.result()
    # after the ranks: rank 0 writes operaCT768_feature.npy into fdir
    saved_file = np.load(fdir / "operaCT768_feature.npy")
    os.makedirs(tmp / "one")
    np.save(tmp / "one" / "sound_dir_loc.npy", np.asarray(paths))
    saved_one = np.load(extract_and_save(str(tmp / "one"), "operaCT", dim=768, batch_size=2,
                                         random_init=True, device="cpu"))
    return dict(want=want, single=single, saved_one=saved_one, saved_file=saved_file, **out)


def test_dp_extraction_returns_the_single_device_rows(extraction):
    """3 WAVs of 6-12 s in batches of 2 (the last padded) over 2 ranks, float32,
    the JAX extractor's weights: the rows of the unsharded port and of the
    JAX extractor on a 2-device mesh at rtol 1e-4 / atol 1e-5; extract_and_save
    (the bf16 flow) writes, from rank 0, the one-device run's features."""
    single, want, saved_one = extraction["single"], extraction["want"], extraction["saved_one"]
    got, saved = extraction["rows"]
    assert got.shape == single.shape == want.shape == (3, 768)
    np.testing.assert_allclose(got, single, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # extract_and_save runs the default bf16 flow, whose rounding follows the
    # batch each rank runs (1 row here, 2 on one device): per-clip cosine
    cos = (saved * saved_one).sum(1) / np.linalg.norm(saved, axis=1) / np.linalg.norm(
        saved_one, axis=1)
    assert cos.min() >= 0.99999, cos
    np.testing.assert_array_equal(extraction["saved_file"], saved)


def test_dp_extractor_refuses_an_indivisible_batch(extraction):
    """batch_size 3 over 2 ranks: "not divisible" (the JAX case at
    tests/test_parallel.py:257)."""
    assert "not divisible" in extraction["odd"]


def _spec_corpus(root, n=12, seed=0):
    r = np.random.default_rng(seed)
    d = root / "feature" / "circor_eval"
    os.makedirs(d / "spec")
    names = []
    for i in range(n):  # longer than circor's 251-frame COLA crop
        np.save(d / "spec" / f"{i}.npy", (r.standard_normal((int(r.integers(260, 300)), 64)) * 4
                                          - 20).astype(np.float32))
        names.append(str(d / "spec" / f"{i}"))
    np.save(d / "entire_spec_filenames.npy", np.asarray(names))


def test_cli_pretrain_dp2_on_the_cpu(tmp_path, monkeypatch):
    """cli.pretrain encoder=efficientnet method=cola dp=2 dist_backend=gloo
    device=cpu: one epoch at batch 4 (2 rows a rank) from disk, rank 0's
    result back, its checkpoint files and CSV written once."""
    monkeypatch.chdir(tmp_path)
    _spec_corpus(tmp_path)
    from heart_murmur_detection_tpu_torch.cli import pretrain as cli_pretrain

    ((sd, hist, _),) = cli_pretrain.main([
        "encoder=efficientnet", "method=cola", "circor=True", "batch_size=4", "epoches=1",
        "dp=2", "dist_backend=gloo", "device=cpu", "title=t", "dim_hidden=1280"])
    assert hist[0]["steps"] == 2 and np.isfinite(hist[0]["train_loss"])
    assert any(k.endswith("_bn0.running_var") for k in sd)
    rows = open(tmp_path / "cks" / "logs" / "combined" / "t" / "metrics.csv").read().splitlines()
    assert len(rows) == 2  # the header and one epoch, from rank 0 alone


def test_cli_finetune_dp2_on_the_cpu(tmp_path, monkeypatch):
    """cli.finetune dp=2 dist_backend=gloo device=cpu on a processed task:
    one seed, one epoch, its checkpoint saved once. The CLI's launch goes
    through with the ranks' HTS-AT narrowed (R.narrow_htsat patched in each
    rank, as tests/test_torch_finetune.py narrows it in-process)."""
    monkeypatch.chdir(tmp_path)
    d = tmp_path / "feature" / "circor_eval"
    os.makedirs(d)
    r = np.random.default_rng(0)
    y = np.arange(24) % 2
    np.save(d / "murmurs.npy", y)
    np.save(d / "train_test_split.npy", np.array(["train"] * 16 + ["val"] * 4 + ["test"] * 4))
    np.save(d / "spectrogram_pad8.npy",
            (r.random((24, 256, 64)) + 0.5 * y[:, None, None]).astype(np.float32))
    np.save(d / "sound_dir_loc.npy", np.array([f"{i}.wav" for i in range(24)]))
    from heart_murmur_detection_tpu_torch.cli import finetune as cli_finetune

    def narrowed(fn, n, cfg, param_sharding, backend=None, device=None, tp=1):
        assert fn is cli_finetune.run_seeds and (n, backend, device, tp) == (2, "gloo", "cpu", 1)
        return launch(R.call, n, "heart_murmur_detection_tpu_torch.cli.finetune:run_seeds",
                      {"cfg": cfg, "param_sharding": param_sharding},
                      (("heart_murmur_detection_tpu_torch.train.finetune", "HTSATConfig",
                        R.narrow_htsat),), backend=backend, device=device)

    monkeypatch.setattr(cli_finetune, "launch", narrowed)
    (scores,) = cli_finetune.main([
        "task=circor_murmurs", "pretrain=operaCT", "random_init=True", "n_run=1", "epochs=1",
        "dp=2", "dist_backend=gloo", "device=cpu"])
    assert len(scores) == 1 and np.isfinite(scores[0])
    ckpts = os.listdir(tmp_path / "cks" / "finetune" / "circor_murmurs")
    assert len(ckpts) == 1 and ckpts[0].endswith(".pt")


def test_dryrun_multichip_two_ranks_on_the_cpu():
    from heart_murmur_detection_tpu_torch.parallel.dryrun import CASES, dryrun_multichip

    out = dryrun_multichip(2, "cpu")
    assert set(out) == {c for c, _ in CASES}
