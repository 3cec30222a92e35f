"""The port's data layer (dsgan_tpu_torch.data) against the JAX package's
(dsgan_tpu.data): the same batches, paths and augmentations for the same
--seed, over two epochs, for the aligned and single datasets and any
thread count; the transforms mode by mode. The JAX loader runs its Python
path (``native_loader="off"``), which tests/test_loader.py holds bit for
bit against its native one."""

import types

import numpy as np
import pytest
from PIL import Image

from dsgan_tpu.data import CreateDataLoader as JaxCreateDataLoader
from dsgan_tpu.data import transforms as jax_transforms
from dsgan_tpu_torch.data import CreateDataLoader
from dsgan_tpu_torch.data import transforms


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    """7 A/B pairs of 40x36 RGB PNGs under train_all/ (half-split pairing),
    larger than the 32x32 crop so the crop offsets are drawn."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    d = root / "train_all"
    d.mkdir()
    for side in "ab":
        for i in range(7):
            Image.fromarray(rng.integers(0, 256, (36, 40, 3), dtype=np.uint8)).save(
                d / f"{side}_{i}.png")
    return root


def _opt(dataroot, **kw):
    opt = dict(dataroot=str(dataroot), phase="train_all", dataset_mode="aligned",
               resize_or_crop="resize_and_crop", seed=7, which_direction="AtoB", input_nc=3,
               output_nc=3, loadSize_w=40, loadSize_h=36, fineSize_w=32, fineSize_h=32,
               no_flip=False, batchSize=3, nThreads=1, max_dataset_size=float("inf"),
               native_loader="off", serial_batches=False)
    opt.update(kw)
    return types.SimpleNamespace(**opt)


def _epochs(loader, n=2):
    return [[b for b in loader.load_data()] for _ in range(n)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for ge, we in zip(got, want):
        assert len(ge) == len(we) and len(ge) > 0
        for gb, wb in zip(ge, we):
            assert sorted(gb) == sorted(wb)
            for k in wb:
                if isinstance(wb[k], np.ndarray):
                    assert gb[k].dtype == wb[k].dtype and gb[k].shape == wb[k].shape, k
                    np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
                else:
                    assert list(gb[k]) == list(wb[k]), k


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("mode,phase", [("aligned", "train"), ("aligned", "test"),
                                        ("single", "train")])
def test_loader_batches_match_jax_over_two_epochs(dataroot, mode, phase, threads):
    kw = dict(dataset_mode=mode, nThreads=threads)
    root = dataroot
    if mode == "single":
        root = dataroot / "train_all"
        kw.update(loadSize_w=40, loadSize_h=40)
    got = _epochs(CreateDataLoader(_opt(root, **kw), phase))
    want = _epochs(JaxCreateDataLoader(_opt(root, **kw), phase))
    _assert_same(got, want)
    first = got[0][0]
    assert first["A"].dtype == np.uint8 and first["A"].shape[1:] == (32, 32, 3)
    # train drops the ragged tail and reshuffles; test keeps file order and the tail
    sizes = [len(b["A_paths"]) for b in got[0]]
    n = 14 if mode == "single" else 7
    assert sizes == ([3] * (n // 3) if phase == "train" else [3] * (n // 3) + [n % 3])
    if phase == "train":
        assert [b["A_paths"] for b in got[0]] != [b["A_paths"] for b in got[1]]


def test_aligned_grayscale_side_matches_jax(dataroot):
    """A one-channel side takes the float path with the luma mix."""
    opt = dict(output_nc=1, which_direction="BtoA", nThreads=2)
    got = _epochs(CreateDataLoader(_opt(dataroot, **opt), "train"), 1)
    want = _epochs(JaxCreateDataLoader(_opt(dataroot, **opt), "train"), 1)
    _assert_same(got, want)
    assert got[0][0]["A"].dtype == np.float32 and got[0][0]["A"].shape[-1] == 1


@pytest.mark.parametrize("uint8", [False, True])
@pytest.mark.parametrize("mode", ["resize_and_crop", "crop", "scale_width",
                                  "scale_width_and_crop"])
def test_transform_matches_jax(dataroot, mode, uint8):
    opt = _opt(dataroot, resize_or_crop=mode, loadSize_w=44, loadSize_h=44)
    img = Image.open(dataroot / "train_all" / "a_0.png").convert("RGB")
    for seed in range(4):
        got = transforms.get_transform(opt, None, uint8=uint8)(img, np.random.default_rng(seed))
        want = jax_transforms.get_transform(opt, None, uint8=uint8)(
            img, np.random.default_rng(seed))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_unknown_transform_mode_raises(dataroot):
    opt = _opt(dataroot, resize_or_crop="zoom")
    img = Image.open(dataroot / "train_all" / "a_0.png").convert("RGB")
    with pytest.raises(ValueError, match="zoom"):
        transforms.get_transform(opt, np.random.default_rng(0))(img)


def test_decode_error_reaches_the_consumer(tmp_path):
    d = tmp_path / "train_all"
    d.mkdir()
    rng = np.random.default_rng(1)
    for side in "ab":
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
                d / f"{side}_{i}.png")
    (d / "b_1.png").write_bytes(b"not a png")
    loader = CreateDataLoader(_opt(tmp_path, loadSize_w=32, loadSize_h=32, batchSize=1,
                                   nThreads=2), "test")
    with pytest.raises(Exception, match="b_1.png|cannot identify"):
        list(loader.load_data())

