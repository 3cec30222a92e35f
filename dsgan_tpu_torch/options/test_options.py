"""Evaluation flags (port of ``dsgan_tpu/options/test_options.py``), for
the eval harness ``dsgan_tpu_torch/test.py``."""

from dsgan_tpu_torch.options.base_options import BaseOptions


class TestOptions(BaseOptions):
    def initialize(self, parser):
        parser = BaseOptions.initialize(self, parser)
        parser.add_argument("--ntest", type=float, default=float("inf"),
                            help="cap on evaluated examples")
        parser.add_argument("--results_dir", type=str, default="./results/",
                            help="directory receiving rendered outputs + metrics CSV")
        parser.add_argument("--aspect_ratio", type=float, default=1.0,
                            help="height rescale applied to saved result images")
        parser.add_argument("--phase", type=str, default="test_all/",
                            help="dataset phase subfolder to evaluate")
        parser.add_argument("--which_epoch", type=str, default="1",
                            help="checkpoint epoch to evaluate ('latest' picks the newest)")
        parser.add_argument("--load_npz", type=str, default="",
                            help="evaluate generator weights from a JAX-layout params .npz "
                                 "instead of a checkpoint")
        parser.add_argument("--how_many", type=int, default=1000,
                            help="number of images to run through the generator")
        parser.add_argument("--inception_weights", type=str, default="",
                            help="converted Inception .npz (torchvision Inception3 keys) for the "
                                 "FID/KID rows; 'random' = random features, pipeline test only")
        self.isTrain = False
        return parser
