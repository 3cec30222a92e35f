"""Datasets: aligned (paired TIR <-> RGB), unaligned (CycleGAN's two
domains) and single (inference only), on the host, index based (port of
``dsgan_tpu/data/datasets.py``); batching and prefetch live in
``loader.py``.

AlignedDataset follows reference DSGAN/data/aligned_dataset.py:27-90:
the directory is dataroot/phase, pairs come from the half-split, then a
random crop offset in [0, loadSize - fineSize - 1], a joint random
horizontal flip and, for one-channel sides, the luma mix.
"""

import os

import numpy as np
from PIL import Image

from dsgan_tpu_torch import runtime
from dsgan_tpu_torch.data import transforms as T
from dsgan_tpu_torch.data.image_folder import list_images, make_dataset


def _open_rgb(path):
    return Image.open(path).convert("RGB")


def _item_rng(seed, serial):
    """The generator of one item, from (--seed, the item's serial).

    The loader fetches items on a thread pool, whose order is not fixed;
    with a serial handed out in stream order by the producer, each item's
    draws depend on its position in the stream alone, so ``--seed`` pins
    the augmentations for any thread count, and they equal the JAX
    package's for the same seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), int(serial)]))


def _sides(opt):
    """(input_nc, output_nc) after --which_direction."""
    if opt.which_direction == "BtoA":
        return opt.output_nc, opt.input_nc
    return opt.input_nc, opt.output_nc


class AlignedDataset:
    def initialize(self, opt, rng=None):
        self.opt = opt
        self.dir_AB = os.path.join(opt.dataroot, opt.phase)
        self.A_paths, self.B_paths = make_dataset(self.dir_AB)
        if opt.resize_or_crop != "resize_and_crop":
            raise ValueError("the aligned dataset takes --resize_or_crop resize_and_crop only")
        self.rng = rng or np.random.default_rng(opt.seed)
        self._seed = opt.seed

    def __getitem__(self, index, serial=None):
        opt = self.opt
        rng = _item_rng(self._seed, serial) if serial is not None else self.rng
        A_path, B_path = self.A_paths[index], self.B_paths[index]
        input_nc, output_nc = _sides(opt)
        # 3-channel recipes stay uint8 on the host: the normalize runs on
        # the device, on a quarter of the bytes; the luma mix of a
        # one-channel side is an f32 op, so that path normalizes here
        u8 = input_nc == 3 and output_nc == 3
        A = np.asarray(_open_rgb(A_path), dtype=np.uint8)
        B = np.asarray(_open_rgb(B_path), dtype=np.uint8)

        w_off_max = max(0, opt.loadSize_w - opt.fineSize_w - 1)
        h_off_max = max(0, opt.loadSize_h - opt.fineSize_h - 1)
        w_off = int(rng.integers(0, w_off_max + 1))
        h_off = int(rng.integers(0, h_off_max + 1))
        A = T.crop(A, h_off, w_off, opt.fineSize_h, opt.fineSize_w)
        B = T.crop(B, h_off, w_off, opt.fineSize_h, opt.fineSize_w)

        if (not opt.no_flip) and rng.random() < 0.5:
            A = T.hflip(A)
            B = T.hflip(B)

        if not u8:
            A = T.normalize(A.astype(np.float32) / 255.0)
            B = T.normalize(B.astype(np.float32) / 255.0)
            if input_nc == 1:
                A = T.rgb_to_gray(A)
            if output_nc == 1:
                B = T.rgb_to_gray(B)
        return {"A": np.ascontiguousarray(A), "B": np.ascontiguousarray(B),
                "A_paths": A_path, "B_paths": B_path}

    def __len__(self):
        return len(self.A_paths)

    def name(self):
        return "AlignedDataset"

    def native_batch(self, indices, num_threads=4, serials=None):
        """The batch of ``indices`` through the native decoder
        (``runtime.load_batch_u8``: decode, crop and flip on C++ threads),
        each A/B pair with one crop offset and one flip. With ``serials``
        the draws are ``__getitem__``'s, in its order (w offset, h offset,
        flip) from the same per-item generator, so the batch equals the
        Python path's bit for bit. Returns None where the Python path must
        run: a one-channel side (the luma mix), no native decoder, or an
        image it could not read (the Python path then raises for a broken
        file, or reads a variant the decoder refuses)."""
        opt = self.opt
        input_nc, output_nc = _sides(opt)
        if input_nc != 3 or output_nc != 3 or not runtime.available():
            return None
        n = len(indices)
        h_max = max(0, opt.loadSize_h - opt.fineSize_h - 1)
        w_max = max(0, opt.loadSize_w - opt.fineSize_w - 1)
        oy, ox, flips = np.zeros(n, np.int64), np.zeros(n, np.int64), np.zeros(n, np.int32)
        if serials is not None:
            for j, s in enumerate(serials):
                r = _item_rng(self._seed, s)
                ox[j] = r.integers(0, w_max + 1)
                oy[j] = r.integers(0, h_max + 1)
                if not opt.no_flip:
                    flips[j] = int(r.random() < 0.5)
        else:
            oy = self.rng.integers(0, h_max + 1, n)
            ox = self.rng.integers(0, w_max + 1, n)
            if not opt.no_flip:
                flips = (self.rng.random(n) < 0.5).astype(np.int32)
        a_paths = [self.A_paths[i] for i in indices]
        b_paths = [self.B_paths[i] for i in indices]
        size = (opt.fineSize_h, opt.fineSize_w)
        a, ok_a = runtime.load_batch_u8(a_paths, oy, ox, flips, *size, num_threads)
        b, ok_b = runtime.load_batch_u8(b_paths, oy, ox, flips, *size, num_threads)
        if ok_a + ok_b != 2 * n:
            return None
        return {"A": a, "B": b, "A_paths": a_paths, "B_paths": b_paths}


class UnalignedDataset:
    """Reference unaligned_dataset.py: the two domains from their own
    directories, ``dataroot/phase + 'A'`` and ``+ 'B'``, each item's B drawn
    at random (``--serial_batches``: in step with A). One draw order, the
    JAX package's: the B index first, then A's crop and flip, then B's, all
    from the item's generator, so the batches equal the JAX loader's bit for
    bit for the same ``--seed``. ``--which_direction`` does not swap the
    directories; it says which side a one-channel recipe projects to luma.
    The native decoder takes no unaligned batch: the loader runs the Python
    path."""

    def initialize(self, opt, rng=None):
        self.opt = opt
        self.dir_A = os.path.join(opt.dataroot, opt.phase + "A")
        self.dir_B = os.path.join(opt.dataroot, opt.phase + "B")
        self.A_paths = list_images(self.dir_A)
        self.B_paths = list_images(self.dir_B)
        self.A_size, self.B_size = len(self.A_paths), len(self.B_paths)
        self.rng = rng or np.random.default_rng(opt.seed)
        self._seed = opt.seed
        # uint8 on the host where no side needs the f32 luma mix
        self.transform = T.get_transform(opt, self.rng,
                                         uint8=opt.input_nc == 3 and opt.output_nc == 3)

    def __getitem__(self, index, serial=None):
        rng = _item_rng(self._seed, serial) if serial is not None else self.rng
        A_path = self.A_paths[index % self.A_size]
        if self.opt.serial_batches:
            index_B = index % self.B_size
        else:
            index_B = int(rng.integers(0, self.B_size))
        B_path = self.B_paths[index_B]
        A = self.transform(_open_rgb(A_path), rng=rng)
        B = self.transform(_open_rgb(B_path), rng=rng)
        input_nc, output_nc = _sides(self.opt)
        if input_nc == 1:
            A = T.rgb_to_gray(A)
        if output_nc == 1:
            B = T.rgb_to_gray(B)
        return {"A": np.ascontiguousarray(A), "B": np.ascontiguousarray(B),
                "A_paths": A_path, "B_paths": B_path}

    def __len__(self):
        return max(self.A_size, self.B_size)

    def name(self):
        return "UnalignedDataset"


class SingleDataset:
    """Reference single_dataset.py: the A side only, over dataroot."""

    def initialize(self, opt, rng=None):
        self.opt = opt
        self.A_paths = list_images(opt.dataroot)
        self.rng = rng or np.random.default_rng(opt.seed)
        self._seed = opt.seed
        self._nc = _sides(opt)[0]
        self.transform = T.get_transform(opt, self.rng, uint8=self._nc == 3)

    def __getitem__(self, index, serial=None):
        rng = _item_rng(self._seed, serial) if serial is not None else self.rng
        A_path = self.A_paths[index]
        A = self.transform(_open_rgb(A_path), rng=rng)
        if self._nc == 1:
            A = T.rgb_to_gray(A)
        return {"A": np.ascontiguousarray(A), "A_paths": A_path}

    def __len__(self):
        return len(self.A_paths)

    def name(self):
        return "SingleDataset"
