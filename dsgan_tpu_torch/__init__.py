"""DS-GAN in PyTorch for NVIDIA Hopper: the serving path of the
MixConvNeXtML generator, the pix2pix train step and the train and eval
CLIs around it (``python -m dsgan_tpu_torch.train`` / ``.test``), with the
ConvNeXt block core as hand-written CUDA kernels (``csrc/``).

Importing this package needs only torch and numpy: the kernels are built
with nvcc at their first launch on a CUDA tensor, never at import.
"""

from dsgan_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
