"""TestModel: inference only (port of ``dsgan_tpu/models/test.py``,
reference DSGAN/models/test_model.py): the generator alone, on the
single-image A-side dataset by default."""

from dsgan_tpu_torch.models.pix2pix import Pix2PixModel


class TestModel(Pix2PixModel):
    def name(self):
        return "TestModel"

    @staticmethod
    def modify_commandline_options(parser, is_train=True):
        if is_train:
            raise ValueError("TestModel cannot be used in train mode")
        parser = Pix2PixModel.modify_commandline_options(parser, is_train=False)
        parser.set_defaults(dataset_mode="single")
        parser.add_argument("--model_suffix", type=str, default="",
                            help="parity flag from the reference test model (unused)")
        return parser

    def initialize(self, opt):
        if opt.isTrain:
            raise ValueError("TestModel cannot be used in train mode")
        Pix2PixModel.initialize(self, opt)
        self.visual_names = ["real_A", "fake_B"]

    def set_input(self, input):
        self.real_A_host = self._local(input["A"])  # a strip on the spatial axis
        self.real_A = self._place_batch(self.real_A_host)
        self.image_paths = input.get("A_paths", [])
