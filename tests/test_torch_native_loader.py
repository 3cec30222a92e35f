"""The port's native batch decoder (``dsgan_tpu_torch/runtime.py`` over
``csrc/loader.cpp``) on the CPU: every PNG colour type and bit depth the
decoder takes, under every zlib strategy and PNG row filter, decodes to
PIL's pixels; JPEG too where the build has libjpeg; a broken file counts
as not decoded; the loader's native batches equal its Python batches and
``dsgan_tpu``'s loader bit for bit for one ``--seed`` across two epochs;
a file the decoder refuses sends the loader to the Python path for good.
Skips only where no C++ compiler can build the library (JPEG: where the
build has no libjpeg)."""

import contextlib
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from dsgan_tpu.data import CreateDataLoader as JaxCreateDataLoader
from dsgan_tpu.options.train_options import TrainOptions as JaxTrainOptions
from dsgan_tpu_torch import runtime
from dsgan_tpu_torch.data import CreateDataLoader
from dsgan_tpu_torch.options.train_options import TrainOptions


@pytest.fixture(scope="module", autouse=True)
def _built():
    if not runtime.available():
        pytest.skip(f"the native decoder did not build: {runtime.reason()}")


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png(values, depth, ctype, rng, level, strategy, palette=None):
    """A PNG of ``values`` (H, W, channels) written here, so that every
    colour type, bit depth, row filter (drawn per row) and zlib strategy
    is reachable; its IDAT split in three chunks."""
    h, w, ch = values.shape
    rows = []
    for y in range(h):
        if depth >= 8:
            rows.append(values[y].reshape(-1).astype(">u2" if depth == 16 else np.uint8).tobytes())
        else:
            bits = "".join(format(int(v), f"0{depth}b") for v in values[y].reshape(-1))
            bits += "0" * (-len(bits) % 8)
            rows.append(bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8)))
    bpp = max(1, ch * depth // 8)
    raw, prior = b"", bytes(len(rows[0]))
    for row in rows:
        f = int(rng.integers(0, 5))
        enc = bytearray(len(row))
        for i in range(len(row)):
            a = row[i - bpp] if i >= bpp else 0
            c = prior[i - bpp] if i >= bpp else 0
            enc[i] = (row[i] - [0, a, prior[i], (a + prior[i]) >> 1, _paeth(a, prior[i], c)][f]) & 255
        raw += bytes([f]) + bytes(enc)
        prior = row
    comp = zlib.compressobj(level, zlib.DEFLATED, 15, 8, strategy)
    z = comp.compress(raw) + comp.flush()
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
    if palette is not None:
        out += _chunk(b"PLTE", palette)
    step = max(1, len(z) // 3)
    for i in range(0, len(z), step):
        out += _chunk(b"IDAT", z[i:i + step])
    return out + _chunk(b"IEND", b"")


FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4), (3, 8), (4, 8),
           (6, 8), (6, 16)]
STRATEGIES = [zlib.Z_DEFAULT_STRATEGY, zlib.Z_FILTERED, zlib.Z_HUFFMAN_ONLY, zlib.Z_RLE, zlib.Z_FIXED]


@pytest.mark.parametrize("ctype,depth", FORMATS, ids=[f"type{c}_{d}bit" for c, d in FORMATS])
def test_png_decodes_to_pils_pixels(tmp_path, ctype, depth):
    """Noise and smooth images of odd sizes, at every zlib level and
    strategy: the decoder's pixels are PIL's convert("RGB") pixels."""
    rng = np.random.default_rng(ctype * 100 + depth)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    for trial in range(10):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        top, palette = (1 << depth) - 1, None
        if ctype == 3:
            n = int(rng.integers(1, min(256, 1 << depth) + 1))
            palette, top = rng.integers(0, 256, 3 * n, dtype=np.uint8).tobytes(), n - 1
        if trial % 2:
            values = rng.integers(0, top + 1, (h, w, ch))
        else:
            values = np.add.outer(np.arange(h), np.arange(w))[..., None] * np.arange(1, ch + 1)
            values = values % (top + 1)
        path = tmp_path / f"t{trial}.png"
        path.write_bytes(_png(values, depth, ctype, rng, trial % 10, STRATEGIES[trial % 5], palette))
        got, ok = runtime.load_batch_u8([str(path)], [0], [0], [0], h, w)
        assert ok == 1, (trial, h, w)
        np.testing.assert_array_equal(got[0], np.asarray(Image.open(path).convert("RGB")))


def test_jpeg_decodes_to_pils_pixels(tmp_path):
    if "jpeg" not in runtime.formats():
        pytest.skip("this build of the native decoder has no libjpeg")
    path = tmp_path / "x.jpg"
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (64, 48, 3), dtype=np.uint8)).save(
        path, quality=95)
    got, ok = runtime.load_batch_u8([str(path)], [0], [0], [0], 64, 48)
    assert ok == 1
    np.testing.assert_array_equal(got[0], np.asarray(Image.open(path).convert("RGB")))
    assert runtime.probe(str(path)) == (48, 64)


def test_broken_files_give_a_zero_count(tmp_path):
    """Not an image, a truncated PNG and a PNG with one flipped byte in its
    compressed data: each counts as not decoded and leaves zeros."""
    img = np.random.default_rng(1).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    img[:20] = 9  # some runs, so that zlib's Huffman blocks carry the data
    good = tmp_path / "good.png"
    Image.fromarray(img).save(good)
    data = good.read_bytes()
    flipped = bytearray(data)
    flipped[len(data) // 2] ^= 0x55
    cases = {"bad.png": b"not an image", "cut.png": data[:len(data) // 2], "flip.png": bytes(flipped)}
    for name, content in cases.items():
        (tmp_path / name).write_bytes(content)
    paths = [str(tmp_path / n) for n in cases] + [str(good)]
    out, ok = runtime.load_batch_u8(paths, [0] * 4, [0] * 4, [0] * 4, 8, 8)
    assert ok == 1 and not out[:3].any() and np.array_equal(out[3], img[:8, :8])
    assert runtime.probe(str(tmp_path / "bad.png")) is None
    assert runtime.probe(str(good)) == (64, 64)


def _dataset(root, n=7, size=(40, 44)):
    rng = np.random.default_rng(3)
    d = root / "train_all"
    d.mkdir(parents=True)
    for side in "ab":
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(
                d / f"{side}_{i}.png")
    return root


ARGV = ["--loadSize_w", "44", "--loadSize_h", "40", "--fineSize_w", "32", "--fineSize_h", "32",
        "--batchSize", "2", "--nThreads", "3", "--seed", "9"]


def _stream(options, root, native, epochs=2):
    """The loader's batches over ``epochs`` epochs, and the loader."""
    with contextlib.redirect_stdout(io.StringIO()):
        opt = options().parse(str(root), str(root / "out"),
                              ARGV + ["--native_loader", native, "--platform", "cpu"])
        loader = (CreateDataLoader if options is TrainOptions else JaxCreateDataLoader)(opt, "train")
        batches = [b for _ in range(epochs) for b in loader]
    return batches, loader


def _assert_same(got, want):
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["A"], w["A"])
        np.testing.assert_array_equal(g["B"], w["B"])
        assert list(g["A_paths"]) == list(w["A_paths"])


def test_native_batches_equal_python_batches_over_two_epochs(tmp_path):
    """Random crops and flips, 3 threads: the native path replays the
    Python path's per-item draws; the loader says which path ran."""
    root = _dataset(tmp_path)
    calls = runtime.load_batch_u8.calls
    native, nl = _stream(TrainOptions, root, "auto")
    python, pl = _stream(TrainOptions, root, "off")
    assert nl.native and not pl.native
    assert runtime.load_batch_u8.calls - calls == 2 * len(native)
    _assert_same(native, python)


def test_native_batches_equal_dsgan_tpu_loader(tmp_path):
    root = _dataset(tmp_path)
    native, _ = _stream(TrainOptions, root, "auto")
    jax_batches, _ = _stream(JaxTrainOptions, root, "off")
    _assert_same(native, jax_batches)


def test_refused_file_falls_back_to_python_path_for_good(tmp_path):
    """A 16-bit grey PNG, which the decoder refuses: the loader prints one
    line, runs the Python path from then on, and its batches stay equal."""
    root = _dataset(tmp_path)
    grey = np.random.default_rng(4).integers(0, 300, (40, 44), dtype=np.uint16)
    Image.fromarray(grey).save(root / "train_all" / "a_3.png")
    native, nl = _stream(TrainOptions, root, "auto")
    python, _ = _stream(TrainOptions, root, "off")
    assert not nl.native
    _assert_same(native, python)
