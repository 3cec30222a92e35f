"""Training flags (port of ``dsgan_tpu/options/train_options.py``; the
reference's 20-epoch recipe: niter 10 + niter_decay 10 linear decay, Adam
lr 2e-4 beta1 0.5, replay pool 50)."""

from dsgan_tpu_torch.options.base_options import BaseOptions


class TrainOptions(BaseOptions):
    def initialize(self, parser):
        parser = BaseOptions.initialize(self, parser)
        parser.add_argument("--display_freq", type=int, default=100,
                            help="steps between preview-image refreshes")
        parser.add_argument("--display_ncols", type=int, default=4,
                            help="preview panel column count")
        parser.add_argument("--update_html_freq", type=int, default=1000,
                            help="steps between HTML gallery snapshots")
        parser.add_argument("--print_freq", type=int, default=100,
                            help="steps between console loss lines (also the metric fetch "
                                 "cadence: metrics stay on the device in between)")
        parser.add_argument("--save_latest_freq", type=int, default=5000,
                            help="steps between 'latest' checkpoint refreshes")
        parser.add_argument("--save_epoch_freq", type=int, default=50,
                            help="epochs between numbered checkpoint saves")
        parser.add_argument("--continue_train", action="store_true", default=False,
                            help="resume from the --which_epoch checkpoint (exact resume: "
                                 "optimizer moments, replay pool, its generator and the step)")
        parser.add_argument("--epoch_count", type=int, default=1,
                            help="epoch numbering starts here (feeds the LR schedule)")
        parser.add_argument("--phase", type=str, default="train_all/",
                            help="dataset phase subfolder to train on")
        parser.add_argument("--which_epoch", type=str, default="1",
                            help="checkpoint epoch to resume from ('latest' picks the newest)")
        parser.add_argument("--niter", type=int, default=10, help="epochs at the full learning rate")
        parser.add_argument("--niter_decay", type=int, default=10,
                            help="epochs over which the rate decays linearly to zero")
        parser.add_argument("--beta1", type=float, default=0.5, help="Adam first-moment decay")
        parser.add_argument("--lr", type=float, default=0.0002, help="Adam learning rate")
        parser.add_argument("--no_lsgan", action="store_true",
                            help="flip the GAN criterion as the reference wires it "
                                 "(GANLoss(use_lsgan=no_lsgan)): off = BCE-with-logits, on = "
                                 "sigmoid D + MSE loss")
        parser.add_argument("--pool_size", type=int, default=50,
                            help="discriminator replay-pool capacity (0 disables)")
        parser.add_argument("--no_html", action="store_true",
                            help="skip writing the HTML result gallery")
        parser.add_argument("--keep_ckpts", type=int, default=0,
                            help="retention: keep only the newest K epoch checkpoints (0 = all)")
        parser.add_argument("--lr_policy", type=str, default="lambda",
                            help="schedule: lambda (linear decay) | step | plateau")
        parser.add_argument("--lr_decay_iters", type=int, default=50,
                            help="step policy: epochs per 0.1x decay")
        parser.add_argument("--steps_per_dispatch", type=int, default=1,
                            help="train steps a chunk: k batches staged in one host-to-device "
                                 "copy; on the card the step is captured in a CUDA graph once "
                                 "the replay pool is full and replayed once a batch")
        parser.add_argument("--profile_dir", type=str, default="",
                            help="write a torch.profiler trace of the --profile_steps range here")
        parser.add_argument("--profile_steps", type=str, default="10:13",
                            help="start:stop steps of this process (0-based, inclusive, rounded "
                                 "to chunk boundaries) that --profile_dir traces")
        parser.add_argument("--debug_nans", action="store_true",
                            help="autograd anomaly detection: raise at the first backward that "
                                 "makes a NaN, naming its forward op (steps run eagerly)")
        parser.add_argument("--detect_anomaly", type=int, default=1,
                            help="1: check fetched metrics for NaN/Inf at print frequency (no "
                                 "extra device sync); on a hit, dump the state and batch and "
                                 "abort with exit code 3. 0: off")
        self.isTrain = True
        return parser
