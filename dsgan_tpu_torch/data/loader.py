"""The batching, prefetching host loader (port of
``dsgan_tpu/data/loader.py``, the reference's CustomDatasetDataLoader,
DSGAN/data/__init__.py:31-63).

A producer thread walks the epoch's index order, decodes each batch's
items on a thread pool (PIL releases the interpreter lock while it
decodes) and stacks them into contiguous NHWC numpy arrays, a bounded
queue ahead of the consumer, so decoding overlaps the device's step. The
threads touch numpy and PIL only; the copy to the card is the model's,
on the main thread (``BaseModel._place_batch``).

The JAX package's native C++ decode path is not ported: ``--native_loader``
parses, and the Python path runs whatever it says.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def CreateDataset(opt, rng=None):
    """Dispatch on --dataset_mode (reference data/__init__.py:12-28)."""
    from dsgan_tpu_torch.data.datasets import AlignedDataset, SingleDataset

    if opt.dataset_mode == "aligned":
        dataset = AlignedDataset()
    elif opt.dataset_mode == "single":
        dataset = SingleDataset()
    elif opt.dataset_mode == "unaligned":
        raise NotImplementedError("the unaligned dataset is not ported yet: it comes with "
                                  "CycleGAN, ROADMAP.md queue A item 15")
    else:
        raise ValueError(f"Dataset [{opt.dataset_mode}] not recognized.")
    dataset.initialize(opt, rng)
    print(f"dataset [{dataset.name()}] was created")
    return dataset


class CustomDatasetDataLoader:
    def name(self):
        return "CustomDatasetDataLoader"

    def initialize(self, opt, phase):
        self.opt = opt
        self.phase = phase
        # one generator for the dataset and the shuffle, as the JAX loader
        # has it: the same --seed gives the same batches
        self.rng = np.random.default_rng(opt.seed)
        self.dataset = CreateDataset(opt, self.rng)
        self.batch_size = opt.batchSize
        self.shuffle = phase == "train"
        self.num_workers = max(1, int(opt.nThreads))
        self.max_items = int(min(len(self.dataset), opt.max_dataset_size or len(self.dataset)))
        self.drop_last = phase == "train"  # fixed shapes: no ragged tail batch
        # per-item serials make the augmentations a function of the stream
        # position; the counter runs on across epochs, so each epoch draws anew
        self._serial = 0
        if opt.native_loader != "off":
            print(f"--native_loader {opt.native_loader}: the native decoder is not ported; "
                  "the Python loader runs")

    def load_data(self):
        return self

    def __len__(self):
        return self.max_items

    def _batches_of_indices(self):
        n = self.max_items
        order = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        end = (n // bs) * bs if self.drop_last else n
        for i in range(0, end, bs):
            yield order[i:i + bs]
        if not self.drop_last and end < n:
            yield order[end:n]

    def _batch(self, pool, idx):
        serials = range(self._serial, self._serial + len(idx))
        self._serial += len(idx)
        items = list(pool.map(self.dataset.__getitem__, idx.tolist(), serials))
        return {key: np.stack([it[key] for it in items]) if isinstance(items[0][key], np.ndarray)
                else [it[key] for it in items] for key in items[0]}

    def __iter__(self):
        q = queue.Queue(maxsize=4)
        sentinel = object()
        stop = threading.Event()  # the consumer is gone: stop producing

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idx in self._batches_of_indices():
                        if stop.is_set() or not put(self._batch(pool, idx)):
                            return
            except Exception as e:  # a decode error: the consumer raises it
                put(e)
                return
            put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10)


def CreateDataLoader(opt, phase):
    data_loader = CustomDatasetDataLoader()
    print(data_loader.name())
    data_loader.initialize(opt, phase)
    return data_loader
