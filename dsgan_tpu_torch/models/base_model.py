"""BaseModel: the lifecycle the training algorithms share (port of
``dsgan_tpu/models/base_model.py``, reference DSGAN/models/
base_model.py:18-177), without the JAX package's mesh and dispatch
chaining.

The shell carries the options, the device, checkpoints, the LR schedule
and the step's metrics. The metrics stay 0-d device tensors until a
caller asks for them; ``fetch_metrics`` brings them over in one copy.
"""

import os
from collections import OrderedDict

import numpy as np
import torch

from dsgan_tpu_torch.device import platform_device
from dsgan_tpu_torch.utils import checkpoint as ckpt
from dsgan_tpu_torch.utils.util import tensor2im


class AnomalyDetected(RuntimeError):
    """A training metric went NaN/Inf (--detect_anomaly). Carries the
    names of the offending metrics and the directory of the dump written
    before raising."""

    def __init__(self, bad_metrics, dump_dir):
        self.bad_metrics = list(bad_metrics)
        self.dump_dir = dump_dir
        super().__init__("non-finite training metrics %s; state dumped to %s"
                         % (self.bad_metrics, dump_dir))


def to_host(scalars):
    """Device 0-d tensors -> floats, in one device-to-host copy."""
    if not scalars:
        return []
    return torch.stack([s.detach().float().reshape(()) for s in scalars]).cpu().tolist()


class BaseModel:
    @staticmethod
    def modify_commandline_options(parser, is_train=True):
        return parser

    def name(self):
        return "BaseModel"

    def initialize(self, opt):
        self.opt = opt
        self.isTrain = opt.isTrain
        self.device = platform_device(opt.platform)
        self.save_dir = os.path.join(opt.checkpoints_dir, opt.name)
        self.loss_names = []
        self.visual_names = []
        self._metrics = {}
        self._host_metrics = None
        self._last_epoch = 0  # LambdaLR's last_epoch
        self.lr = getattr(opt, "lr", 0.0)
        # the plateau policy's state (torch ReduceLROnPlateau semantics)
        self._plateau_best = float("inf")
        self._plateau_bad = 0
        self._plateau_scale = 1.0

    def _place_batch(self, arr):
        """A host NHWC batch on the device. On the card the copy leaves from
        pinned memory without blocking the host. uint8 batches travel raw,
        a quarter of the bytes; the step normalizes them."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- lifecycle ---------------------------------------------------------
    def setup(self, opt):
        """Load a checkpoint when testing or resuming (reference
        base_model.py:38-45) and set the LR from the schedule."""
        if not self.isTrain or getattr(opt, "continue_train", False):
            self.load_networks(getattr(opt, "which_epoch", "latest"))
        if self.isTrain:
            self._set_lr_from_schedule()

    def set_input(self, input):
        raise NotImplementedError

    def optimize_parameters(self):
        raise NotImplementedError

    def forward(self):
        raise NotImplementedError

    def test(self):
        with torch.no_grad():
            self.forward()

    # -- learning rate (torch LambdaLR semantics, networks.py:33-39) -------
    def _lr_lambda(self, last_epoch):
        opt = self.opt
        num = max(0, last_epoch + 1 + opt.epoch_count - opt.niter)
        return 1.0 - num / float(opt.niter_decay + 1)

    def _set_lr_from_schedule(self):
        policy = getattr(self.opt, "lr_policy", "lambda")
        if policy == "lambda":
            self.lr = self.opt.lr * self._lr_lambda(self._last_epoch)
        elif policy == "step":
            self.lr = self.opt.lr * (0.1 ** (self._last_epoch // self.opt.lr_decay_iters))
        elif policy == "plateau":
            self.lr = self.opt.lr * self._plateau_scale
        else:
            raise NotImplementedError(f"learning rate policy [{policy}] is not implemented")

    def _plateau_step(self, metric):
        """torch ReduceLROnPlateau with the reference's settings
        (networks.py:42-44: mode min, factor 0.2, threshold 0.01 relative,
        patience 5): lr *= 0.2 once the metric has failed to improve past
        best * (1 - 0.01) for more than 5 epochs in a row."""
        if metric is None:
            # no metric given: the last generator loss, as the JAX package
            # does (the reference's epoch loop never passes one)
            metric = self.get_current_metrics().get("loss_G", None)
        if metric is None:
            return
        metric = float(metric)
        if metric < self._plateau_best * (1.0 - 0.01):
            self._plateau_best = metric
            self._plateau_bad = 0
        else:
            self._plateau_bad += 1
        if self._plateau_bad > 5:
            self._plateau_scale *= 0.2
            self._plateau_bad = 0

    def update_learning_rate(self, metric=None):
        """Step the schedule at the end of an epoch (base_model.py:68-72);
        ``metric`` feeds the plateau policy."""
        self._last_epoch += 1
        if getattr(self.opt, "lr_policy", "lambda") == "plateau":
            self._plateau_step(metric)
        self._set_lr_from_schedule()
        print("learning rate = %.7f" % self.lr)

    # -- metrics -----------------------------------------------------------
    def fetch_metrics(self, pending=()):
        """Copy the last step's 0-d metrics and the device scalars
        ``pending`` to the host in one transfer; the metrics are kept as
        floats, the values of ``pending`` returned."""
        keys = [k for k, v in self._metrics.items() if v.dim() == 0]
        vals = to_host(list(pending) + [self._metrics[k] for k in keys])
        self._host_metrics = dict(zip(keys, vals[len(pending):]))
        return vals[:len(pending)]

    def get_current_metrics(self):
        if self._host_metrics is None:
            self.fetch_metrics()
        return dict(self._host_metrics)

    def get_current_losses(self):
        """The last step's losses as floats, under the reference's names."""
        vals = self.get_current_metrics()
        return OrderedDict((n, vals["loss_" + n]) for n in self.loss_names
                           if "loss_" + n in vals)

    def check_anomaly(self, context=""):
        """Failure detection (the reference has none: a NaN run trains on
        and saves garbage). Reads the fetched metrics; on a NaN/Inf writes
        the state as the 'anomaly' checkpoint (``--which_epoch anomaly``
        restores it), the last input batch as .npy and a report, then
        raises AnomalyDetected."""
        vals = self.get_current_metrics()
        bad = sorted(k for k, v in vals.items() if not np.isfinite(v))
        if not bad:
            return
        dump_dir = os.path.join(self.save_dir, "anomaly")
        os.makedirs(dump_dir, exist_ok=True)
        ckpt.save_state(self.save_dir, "anomaly", self._checkpoint_state())
        for name in ("real_A", "real_B"):
            arr = getattr(self, name + "_host", None)
            if arr is not None:
                np.save(os.path.join(dump_dir, f"{name}.npy"), np.asarray(arr))
        with open(os.path.join(dump_dir, "report.txt"), "w") as f:
            f.write("context: %s\nnon-finite metrics: %s\nall metrics: %s\n"
                    % (context, bad, vals))
        raise AnomalyDetected(bad, dump_dir)

    def get_current_visuals(self):
        """uint8 HWC images of the first sample: the host batch for the
        inputs, the first image fetched from the device for the rest."""
        out = OrderedDict()
        for name in self.visual_names:
            val = getattr(self, name + "_host", None)
            if val is None:
                val = getattr(self, name, None)
                if isinstance(val, torch.Tensor):
                    val = val[:1].cpu()
            if val is not None:
                out[name] = tensor2im(val)
        return out

    # -- persistence -------------------------------------------------------
    def _checkpoint_state(self):
        raise NotImplementedError

    def _load_checkpoint_state(self, state):
        raise NotImplementedError

    def save_networks(self, which_epoch):
        path = ckpt.save_state(self.save_dir, which_epoch, self._checkpoint_state())
        print(f"saved checkpoint: {path}")
        k = int(getattr(self.opt, "keep_ckpts", 0) or 0)
        if k > 0:
            ckpt.keep_latest(self.save_dir, k)

    def _resolve_epoch(self, which_epoch):
        if which_epoch == "latest":
            which_epoch = ckpt.latest_epoch(self.save_dir)
            if which_epoch is None:
                raise FileNotFoundError(f"no checkpoints in {self.save_dir}")
        return which_epoch

    def load_networks(self, which_epoch):
        which_epoch = self._resolve_epoch(which_epoch)
        self._load_checkpoint_state(ckpt.restore_state(self.save_dir, which_epoch))
        print(f"loaded checkpoint epoch {which_epoch} from {self.save_dir}")
