"""The port's FID / KID (dsgan_tpu_torch.models.inception, ops/fid.py,
ops/resize.py, the fid CLI and the eval CLI's rows) against the JAX
package's:

* pool3 features against ``InceptionPool3`` on the same random weights,
  both graphs (the FID variant and torchvision's), one jitted JAX call
  each at 75x75 (the smallest input the graph takes), batch 2: rtol 1e-4,
  atol 1e-5. The weights cross as an npz of torchvision keys, which the
  JAX package's ``load_torchvision_npz`` reads, and back through
  ``inception_state_dict_from_jax``;
* ``prepare_images`` at 256 -> 299 (enlarging) and 320 -> 299 (shrinking,
  antialiased): atol 1e-4, the size of JAX's own f32 error against a
  float64 evaluation of the same weights (~3e-5 on the CPU);
* ``frechet_distance`` / ``kid_from_features`` equal JAX's on one feature
  set (the same float64 numpy code);
* the fid CLI, end to end on the CPU, against the JAX fid CLI on the same
  folders and weights: the features each hands its FID at the pool3
  tolerance, the KID at rel 1e-3 (one FID matrix square root, the port's);
* the eval CLI's ``fid`` / ``kid`` rows: those of the features of the
  fake_B and real_B images it saved."""

import contextlib
import csv
import importlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dsgan_tpu import fid as jax_fid_cli
from dsgan_tpu.models import inception as jinc
from dsgan_tpu.ops import fid as jfid
from dsgan_tpu_torch import fid as fid_cli
from dsgan_tpu_torch.models import inception as tinc
from dsgan_tpu_torch.test import main as eval_main
from dsgan_tpu_torch.train import main as train_main
from dsgan_tpu_torch.utils.convert import inception_state_dict_from_jax

tfid = importlib.import_module("dsgan_tpu_torch.ops.fid")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The port's random extractor saved as a torchvision-key npz."""
    net = tinc.define_inception("random", device="cpu", seed=5)
    path = tmp_path_factory.mktemp("inception") / "inception.npz"
    np.savez(path, **{k: v.numpy() for k, v in net.state_dict().items()})
    return path, net.state_dict()


def test_inception_weights_cross_both_ways(weights):
    path, sd = weights
    jparams = jinc.load_torchvision_npz(str(path))["params"]
    back = inception_state_dict_from_jax(jparams)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    assert sum(v.numel() for k, v in sd.items() if "num_batches" not in k) == \
        sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(jparams))


@pytest.mark.parametrize("fid_variant", [True, False], ids=["fid_graph", "torchvision_graph"])
def test_pool3_features_match_jax(weights, fid_variant):
    path, sd = weights
    x = np.random.default_rng(0).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    variables = jax.tree_util.tree_map(jnp.asarray, jinc.load_torchvision_npz(str(path)))
    want = np.asarray(jax.jit(jinc.InceptionPool3(fid_variant=fid_variant).apply)(
        variables, jnp.asarray(x)))
    net = tinc.define_inception(sd, fid_variant, device="cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("size", [(256, 256), (320, 320), (299, 240)],
                         ids=["256_up", "320_down", "mixed"])
def test_prepare_images_matches_jax(size):
    x = np.random.default_rng(1).uniform(-1.2, 1.2, (2, *size, 3)).astype(np.float32)
    want = np.asarray(jinc.prepare_images(jnp.asarray(x)))
    got = tinc.prepare_images(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    if size == (320, 320):
        # a shrink is not torch's bilinear interpolation: the filter widens
        plain = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                                                (299, 299), mode="bilinear")
        assert float((plain.clamp(-1, 1).permute(0, 2, 3, 1) - got).abs().max()) > 1e-2


def test_frechet_distance_and_kid_equal_jax():
    rng = np.random.default_rng(2)
    f1 = rng.standard_normal((40, 16)).astype(np.float32)
    f2 = (rng.standard_normal((30, 16)) * 1.3 + 0.2).astype(np.float32)
    assert tfid.fid_from_features(f1, f2) == jfid.fid_from_features(f1, f2)
    m1, s1 = tfid.activation_stats(f1)
    m2, s2 = tfid.activation_stats(f2)
    assert tfid.frechet_distance(m1, s1, m2, s2) == jfid.frechet_distance(m1, s1, m2, s2)
    assert tfid.kid_from_features(f1, f2, subset_size=20) == \
        jfid.kid_from_features(f1, f2, subset_size=20)
    assert tfid.fid_from_features(f1, f1) == pytest.approx(0.0, abs=1e-6)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("fid_folders")
    rng = np.random.default_rng(3)
    for name, n in (("a", 4), ("b", 5)):
        (root / name).mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(
                root / name / f"{name}_{i}.png")
    return root


def test_fid_cli_matches_the_jax_cli(weights, folders, monkeypatch):
    """Both CLIs on the same folders and weights, the FID's 2048x2048
    matrix square root paid once: the port CLI computes its own FID end
    to end, and the JAX CLI's ``fid_from_features`` only records the
    features it is handed. Those are held against the port CLI's at the
    pool3 test's tolerance, and the FID over either set is the same
    float64 code (``test_frechet_distance_and_kid_equal_jax``). Both CLIs
    compute their KID, compared at rel 1e-3 (few images: the estimate
    amplifies the features' f32 differences)."""
    seen = {}
    port_fid = tfid.fid_from_features

    def port_spy(fa, fb):
        seen["port"] = (fa, fb, port_fid(fa, fb))
        return seen["port"][2]

    def jax_spy(fa, fb):
        seen["jax"] = (fa, fb)
        return float("nan")

    monkeypatch.setattr(tfid, "fid_from_features", port_spy)
    monkeypatch.setattr(jfid, "fid_from_features", jax_spy)
    argv = ["--dir_a", str(folders / "a"), "--dir_b", str(folders / "b"),
            "--inception_weights", str(weights[0]), "--batch", "4"]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = fid_cli.main(argv + ["--platform", "cpu"])
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == got
    with contextlib.redirect_stdout(io.StringIO()):
        want = jax_fid_cli.main(argv)
    assert sorted(got) == sorted(want)
    assert (got["n_a"], got["n_b"]) == (want["n_a"], want["n_b"]) == (4, 5)
    for side, (g, w) in enumerate(zip(seen["port"][:2], seen["jax"])):
        assert np.shape(g) == np.shape(w) == ((4, 5)[side], 2048)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    assert got["fid"] == seen["port"][2] and np.isfinite(got["fid"])
    for k in ("kid", "kid_std"):
        assert got[k] == pytest.approx(want[k], rel=1e-3), k


def test_fid_cli_needs_a_card_unless_the_cpu_is_asked_for(folders):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fid_cli.main(["--dir_a", str(folders / "a"), "--dir_b", str(folders / "b")])


def test_eval_cli_writes_fid_and_kid_rows(weights, tmp_path, monkeypatch):
    """A pix2pix run of one epoch (resnet_6blocks, ngf 8), then its eval
    with --inception_weights: the features the CLI hands ``ops/fid.py`` are
    the extractor's features of the fake_B and real_B images it saved, and
    the fid / kid rows are what ``fid_from_features`` / ``kid_from_features``
    return for them. The FID itself is a stand-in here (a sum of the
    features): its arithmetic is held against JAX above, and each real FID
    costs a ~20 s matrix square root on the CPU."""
    rng = np.random.default_rng(4)
    for phase, n in (("train_all", 4), ("test_all", 3)):
        d = tmp_path / "data" / phase
        d.mkdir(parents=True)
        for side in "ab":
            for i in range(n):
                Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
                    d / f"{side}_{i}.png")
    common = ["--platform", "cpu", "--dtype", "float32", "--which_model_netG", "resnet_6blocks",
              "--ngf", "8", "--ndf", "8", "--loadSize_w", "32", "--loadSize_h", "32",
              "--fineSize_w", "32", "--fineSize_h", "32", "--name", "f",
              "--dataroot", str(tmp_path / "data"), "--checkpoints_dir", str(tmp_path / "c")]
    seen = {}

    def fid_stand_in(ff, fr):
        seen["fid"] = (ff, fr)
        return float(np.sum(ff) - np.sum(fr))

    def kid_spy(ff, fr, **kw):
        seen["kid"] = (ff, fr, kw)
        return jfid.kid_from_features(ff, fr, **kw)

    monkeypatch.setattr(tfid, "fid_from_features", fid_stand_in)
    monkeypatch.setattr(tfid, "kid_from_features", kid_spy)
    with contextlib.redirect_stdout(io.StringIO()):
        train_main(common + ["--batchSize", "2", "--niter", "1", "--niter_decay", "0",
                             "--w_vgg", "0"])
        eval_main(common + ["--which_epoch", "1", "--results_dir", str(tmp_path / "r"),
                            "--inception_weights", str(weights[0])])
    web_dir = tmp_path / "r" / "f" / "test_all/_1"
    lines = list(csv.reader(open(web_dir / "metrics.csv")))
    assert [r[0] for r in lines] == ["index", "0", "1", "2", "mean", "fid", "kid"]
    extract = tinc.make_feature_fn(str(weights[0]), device="cpu")
    ff, fr = (extract(np.asarray(Image.open(web_dir / "images" / f"a_{i}_{v}.png"))
                      for i in range(3)) for v in ("fake_B", "real_B"))
    for name in ("fid", "kid"):
        np.testing.assert_array_equal(seen[name][0], ff)
        np.testing.assert_array_equal(seen[name][1], fr)
    assert seen["kid"][2] == {"subset_size": 3}
    assert float(lines[5][2]) == pytest.approx(float(np.sum(ff) - np.sum(fr)), rel=1e-12)
    kid, kid_std = jfid.kid_from_features(ff, fr, subset_size=3)
    assert float(lines[6][2]) == pytest.approx(kid, rel=1e-12)
    assert float(lines[6][3]) == pytest.approx(kid_std, rel=1e-12)
