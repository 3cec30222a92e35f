"""The batching, prefetching host loader (port of
``dsgan_tpu/data/loader.py``, the reference's CustomDatasetDataLoader,
DSGAN/data/__init__.py:31-63).

A producer thread walks the epoch's index order and makes each batch, a
bounded queue ahead of the consumer, so decoding overlaps the device's
step. With ``--native_loader auto`` (the default) a dataset that has
``native_batch`` decodes, crops and flips the whole batch on C++ threads
(``dsgan_tpu_torch/runtime.py``), outside the interpreter lock; where it
returns None the loader says so in one line and falls back for good to
the Python path, which decodes each item on a thread pool and stacks
them; a dataset without ``native_batch`` (unaligned, single) says so in
one line and takes the Python path. ``native`` records which path is running. Both paths give the same
batches bit for bit for the same ``--seed``. The threads touch numpy, PIL
and the native decoder only; the copy to the card is the model's, on the
main thread (``BaseModel._place_batch``).

``epoch_start`` is where the current epoch began (the shuffle generator's
state and the next item serial); ``resume_at`` makes the next epoch start
there again and skip the batches already trained on, so a run stopped
mid-epoch resumes on the same batches.
"""

import copy
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def CreateDataset(opt, rng=None):
    """Dispatch on --dataset_mode (reference data/__init__.py:12-28)."""
    from dsgan_tpu_torch.data.datasets import AlignedDataset, SingleDataset, UnalignedDataset

    if opt.dataset_mode == "aligned":
        dataset = AlignedDataset()
    elif opt.dataset_mode == "unaligned":
        dataset = UnalignedDataset()
    elif opt.dataset_mode == "single":
        dataset = SingleDataset()
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
        # which path makes the batches: the native decoder until it returns
        # None, then the Python path for good
        self.native = opt.native_loader != "off" and hasattr(self.dataset, "native_batch")
        if opt.native_loader != "off" and not self.native:
            print(f"--native_loader {opt.native_loader}: the native decoder has no "
                  f"{self.dataset.name()} path; the Python loader runs")
        self.epoch_start = None
        self._resume = None

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

    def resume_at(self, epoch_start, batches_done):
        """Start the next epoch where ``epoch_start`` (a past
        ``epoch_start``) says and skip its first ``batches_done`` batches."""
        self._resume = (epoch_start, int(batches_done))

    def _batch(self, pool, idx, serials):
        if self.native:
            batch = self.dataset.native_batch(idx.tolist(), self.num_workers, serials=serials)
            if batch is not None:
                return batch
            self.native = False
            from dsgan_tpu_torch import runtime

            why = runtime.reason() or "this recipe or one of its images needs the Python path"
            print(f"--native_loader {self.opt.native_loader}: the native decoder does not take "
                  f"this batch ({why}); the Python loader runs from here on")
        items = list(pool.map(self.dataset.__getitem__, idx.tolist(), serials))
        return {key: np.stack([it[key] for it in items]) if isinstance(items[0][key], np.ndarray)
                else [it[key] for it in items] for key in items[0]}

    def __iter__(self):
        skip = 0
        if self._resume is not None:
            (rng_state, self._serial), skip = self._resume
            self.rng.bit_generator.state = copy.deepcopy(rng_state)
            self._resume = None
        self.epoch_start = (copy.deepcopy(self.rng.bit_generator.state), self._serial)
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
                    for n, idx in enumerate(self._batches_of_indices()):
                        serials = list(range(self._serial, self._serial + len(idx)))
                        self._serial += len(idx)
                        if n < skip:
                            continue
                        if stop.is_set() or not put(self._batch(pool, idx, serials)):
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
