"""Models of the port: the MixConvNeXtML generator, the PatchGAN
discriminator, the VGG16 perceptual features and the pix2pix train step."""

from dsgan_tpu_torch.models.registry import (
    define_D,
    define_G,
    define_vgg,
    init_d_params,
    init_params,
    init_vgg_params,
)

__all__ = ["define_D", "define_G", "define_vgg", "init_d_params", "init_params",
           "init_vgg_params"]
