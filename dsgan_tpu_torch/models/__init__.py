"""Models of the port: the MixConvNeXtML generator, the PatchGAN
discriminator, the VGG16 perceptual features, the Inception-v3 pool3
features, the pix2pix and CycleGAN train steps and the model shells the
CLIs create by name (``pix2pix``, ``cycle_gan``, ``test``)."""

from dsgan_tpu_torch.models.registry import (
    create_model,
    define_D,
    define_G,
    define_vgg,
    find_model_using_name,
    get_option_setter,
    init_d_params,
    init_params,
    init_vgg_params,
)

__all__ = ["create_model", "define_D", "define_G", "define_vgg", "find_model_using_name",
           "get_option_setter", "init_d_params", "init_params", "init_vgg_params"]
