"""The port's UnalignedDataset (dsgan_tpu_torch.data.datasets) and its
loader route against the JAX package's: the same batches, paths and
augmentations bit for bit for the same --seed, over two epochs, with
random and serial B pairing, unequal A / B counts, --which_direction BtoA
and a one-channel side; the native decoder has no unaligned path, so
``--native_loader auto`` says so and runs the Python loader."""

import types

import numpy as np
import pytest
from PIL import Image

from dsgan_tpu.data import CreateDataLoader as JaxCreateDataLoader
from dsgan_tpu_torch.data import CreateDataLoader


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    """trainA/ with 5 and trainB/ with 7 RGB PNGs of 40x36, larger than
    the 32x32 crop so that crop offsets are drawn."""
    root = tmp_path_factory.mktemp("unaligned")
    rng = np.random.default_rng(3)
    for side, n in (("A", 5), ("B", 7)):
        d = root / f"train{side}"
        d.mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (36, 40, 3), dtype=np.uint8)).save(
                d / f"{side.lower()}_{i}.png")
    return root


def _opt(dataroot, **kw):
    opt = dict(dataroot=str(dataroot), phase="train", dataset_mode="unaligned",
               resize_or_crop="crop", seed=11, which_direction="AtoB", input_nc=3,
               output_nc=3, loadSize_w=40, loadSize_h=36, fineSize_w=32, fineSize_h=32,
               no_flip=False, batchSize=2, nThreads=1, max_dataset_size=float("inf"),
               native_loader="off", serial_batches=False)
    opt.update(kw)
    return types.SimpleNamespace(**opt)


def _epochs(loader, n=2):
    return [[b for b in loader.load_data()] for _ in range(n)]


CASES = {
    "random_pairing": {},
    "random_pairing_3_threads": dict(nThreads=3),
    "serial_pairing": dict(serial_batches=True),
    "btoa": dict(which_direction="BtoA"),
    "one_channel_side": dict(output_nc=1, which_direction="BtoA"),
    "resize_and_crop": dict(resize_or_crop="resize_and_crop", loadSize_w=36, loadSize_h=36),
}


@pytest.mark.parametrize("case", list(CASES))
def test_unaligned_batches_match_jax_over_two_epochs(dataroot, case):
    opt = _opt(dataroot, **CASES[case])
    got = _epochs(CreateDataLoader(opt, "train"))
    want = _epochs(JaxCreateDataLoader(opt, "train"))
    assert len(got) == len(want) == 2
    for ge, we in zip(got, want):
        # max(5, 7) = 7 items, batches of 2, the ragged tail dropped
        assert len(ge) == len(we) == 3
        for gb, wb in zip(ge, we):
            assert sorted(gb) == sorted(wb) == ["A", "A_paths", "B", "B_paths"]
            for k in ("A", "B"):
                assert gb[k].dtype == wb[k].dtype and gb[k].shape == wb[k].shape, k
                np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
            assert list(gb["A_paths"]) == list(wb["A_paths"])
            assert list(gb["B_paths"]) == list(wb["B_paths"])
    first = got[0][0]
    if case == "one_channel_side":
        # BtoA with output_nc 1: the A side (input_nc after the swap) is luma
        assert first["A"].dtype == np.float32 and first["A"].shape[-1] == 1
        assert first["B"].shape[-1] == 3
    else:
        assert first["A"].dtype == np.uint8 and first["A"].shape[1:] == (32, 32, 3)
    a_dirs = {p.split("/")[-2] for b in got[0] for p in b["A_paths"]}
    assert a_dirs == {"trainA"}  # the direction does not swap the directories
    if case == "serial_pairing":
        for b in got[0]:
            for pa, pb in zip(b["A_paths"], b["B_paths"]):
                ia, ib = int(pa[-5]), int(pb[-5])
                assert ib == ia or ia + 5 == ib  # index % size on each side


def test_unaligned_len_and_native_route(dataroot, capsys):
    loader = CreateDataLoader(_opt(dataroot, native_loader="auto"), "train")
    assert len(loader) == 7 and loader.dataset.name() == "UnalignedDataset"
    assert loader.native is False
    assert "the Python loader runs" in capsys.readouterr().out
    assert len(_epochs(loader, 1)[0]) == 3
