"""Console, log and HTML output of the CLIs (port of
``dsgan_tpu/utils/visualizer.py``, reference DSGAN/util/visualizer.py
without its visdom path)."""

import os
import time

import numpy as np

from dsgan_tpu_torch.utils import html, util
from dsgan_tpu_torch.utils.util import tensor2im


def save_images(webpage, visuals, image_path, aspect_ratio=1.0):
    """Save the input / output / target images of one sample and add them
    to the webpage (reference visualizer.py:16-43)."""
    image_dir = webpage.get_image_dir()
    short_path = os.path.basename(image_path[0] if isinstance(image_path, list) else image_path)
    name = os.path.splitext(short_path)[0]

    webpage.add_header(name)
    ims, txts, links = [], [], []
    for label, im in visuals.items():
        image_name = f"{name}_{label}.png"
        util.save_image(im, os.path.join(image_dir, image_name))
        ims.append(image_name)
        txts.append(label)
        links.append(image_name)
    webpage.add_images(ims, txts, links)


def save_images2(webpage, visuals, image_path, aspect_ratio=1.0):
    """The input / output / target writer with the reference's prefixes
    (reference visualizer.py:46-65, ``dsgan_tpu/utils/visualizer.py:86-102``):
    ``input_{name}.png``, ``output_{name}.png``, ``target_{name}.png`` in one
    row of the webpage."""
    image_dir = webpage.get_image_dir()
    short_path = os.path.basename(image_path[0] if isinstance(image_path, list) else image_path)
    name = os.path.splitext(short_path)[0]
    webpage.add_header(name)
    prefix = {"real_A": "input", "fake_B": "output", "real_B": "target"}
    ims, txts, links = [], [], []
    for label, im in visuals.items():
        image_name = f"{prefix.get(label, label)}_{name}.png"
        util.save_image(im, os.path.join(image_dir, image_name))
        ims.append(image_name)
        txts.append(prefix.get(label, label))
        links.append(image_name)
    webpage.add_images(ims, txts, links)


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        self.name = opt.name
        self.saved = False
        self.use_html = opt.isTrain and not getattr(opt, "no_html", False)
        if self.use_html:
            self.web_dir = os.path.join(opt.checkpoints_dir, opt.name, "web")
            self.img_dir = os.path.join(self.web_dir, "images")
            util.mkdirs([self.web_dir, self.img_dir])
        self.log_name = os.path.join(opt.checkpoints_dir, opt.name, "loss_log.txt")
        with open(self.log_name, "a") as log_file:
            log_file.write(f"================ Training Loss ({time.strftime('%c')}) "
                           "================\n")

    def reset(self):
        self.saved = False

    def display_current_results(self, visuals, epoch, save_result):
        """Write the current visuals into the web gallery."""
        if not self.use_html or not (save_result or not self.saved):
            return
        self.saved = True
        for label, image in visuals.items():
            img = image if isinstance(image, np.ndarray) else tensor2im(image)
            util.save_image(img, os.path.join(self.img_dir, f"epoch{epoch:03d}_{label}.png"))
        webpage = html.HTML(self.web_dir, f"Experiment name = {self.name}", reflesh=1)
        for n in range(epoch, 0, -1):
            webpage.add_header(f"epoch [{n}]")
            names = [f"epoch{n:03d}_{label}.png" for label in visuals]
            webpage.add_images(names, list(visuals), names)
        webpage.save()

    def print_current_losses(self, epoch, i, losses, t, t_data, ssim=None, psnr=None):
        """The console and loss_log.txt line, with the running SSIM / PSNR
        (reference visualizer.py:181-188)."""
        message = "(epoch: %d, iters: %d, time: %.3f, data: %.3f) " % (epoch, i, t, t_data)
        for k, v in losses.items():
            message += "%s: %.3f " % (k, v)
        if ssim is not None:
            message += "SSIM: %.4f " % ssim
        if psnr is not None:
            message += "PSNR: %.3f " % psnr
        print(message)
        with open(self.log_name, "a") as log_file:
            log_file.write(f"{message}\n")
