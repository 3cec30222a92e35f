"""Data layer of the port: the aligned and single datasets and a threaded,
prefetching host loader of uint8 NHWC batches (port of
``dsgan_tpu/data``). Directory conventions, the half-split A/B pairing of
reference image_folder.py:24-34 and the transforms are the reference's."""

from dsgan_tpu_torch.data.loader import CreateDataLoader, CreateDataset

__all__ = ["CreateDataLoader", "CreateDataset"]
