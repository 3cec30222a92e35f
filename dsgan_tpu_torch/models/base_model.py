"""BaseModel: the lifecycle the training algorithms share (port of
``dsgan_tpu/models/base_model.py``, reference DSGAN/models/
base_model.py:18-177); and ``ChainedStep``, the counterpart of its
``make_chained_step``, which on the card replays one train step captured
in a CUDA graph.

The shell carries the options, the device, the (data, spatial) mesh,
checkpoints, the LR schedule and the step's metrics. The metrics stay 0-d
device tensors until a caller asks for them; ``fetch_metrics`` brings
them over in one copy. With ``--data_axis`` / ``--spatial_axis`` over
several ranks (``parallel.mesh``; the counterpart of ``_jit_step`` /
``_place_batch``, ``dsgan_tpu/models/base_model.py:156-236``) each rank
keeps its rows of the global batch, and on a spatial axis its strip of
their image rows (``_local``), the state is broadcast from rank 0 once
(``_on_mesh``), the steps reduce over the mesh, the visuals are gathered
from the strips, and only rank 0 writes checkpoints while the others wait
for it. Eval resolves ``data 1 x spatial S``, as the JAX package does.
"""

import os
from collections import OrderedDict

import numpy as np
import torch

from dsgan_tpu_torch.device import platform_device
from dsgan_tpu_torch.models.layers import set_batchnorm_mesh
from dsgan_tpu_torch.parallel import (
    comms,
    gather_image_rows,
    multihost,
    replicate,
    resolve_mesh,
    shard_batch,
)
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


class ChainedStep:
    """k train steps a chunk (``--steps_per_dispatch``): the H100 form of
    ``make_chained_step`` in ``dsgan_tpu/models/base_model.py:36-112``, for
    any step on the contract ``step_fn(state, *batches, lr) -> (metrics,
    out)``, ``metrics`` a dict of 0-d tensors and ``out`` one tensor. JAX
    scans k steps in one program so that the host dispatches once; here
    the step is captured once in a CUDA graph and replayed once a batch, so
    the host launches one graph in place of the step's thousand kernels.

    On the card the capture reads static device copies of the batches and
    a 0-d device learning rate; for each batch ``step`` copies the batch
    and the rate into them and replays the graph. A step runs eagerly
    instead, on the same side stream as the capture and the replays, while
    ``ready(state)`` is false (a host-side branch of the step still moves:
    the replay pool filling), for the first ``warmup`` steps (the kernels'
    builds and plans and the optimizers' lazy state are made there, not
    inside the capture), and when the caller asks (``eager=True``). The
    generators ``generators(state)`` are registered with the graph, so each
    replay draws what an eager step would and advances them as far. A
    capture that fails raises: nothing falls back to eager steps. On the
    CPU every step is eager: no graph exists there.

    The graph holds the addresses of the state's tensors. A caller that
    replaces them (loading a checkpoint into the optimizers) calls
    ``reset``. ``counts``: steps run eagerly, captured, replayed. A capture
    runs nothing (the replay after it runs the step), but the kernel
    wrappers count their launches during it, once for the captured step; a
    replay adds to no launch count.
    """

    def __init__(self, step_fn, ready=None, generators=None, warmup=1):
        self.step_fn = step_fn
        self.ready = ready or (lambda state: True)
        self.generators = generators or (lambda state: ())
        self.warmup = warmup
        self.keys = None  # the metric names, in the order of the vectors
        self.stream = None
        self.counts = dict(eager=0, captured=0, replayed=0)
        self.reset()

    def reset(self):
        """Drop the graph; the next ready step captures anew."""
        self.graph = None
        self._static = None

    def _vector(self, metrics):
        if self.keys is None:
            self.keys = list(metrics)
        return torch.stack([metrics[k].detach().float().reshape(()) for k in self.keys])

    def _eager(self, state, inputs, lr):
        metrics, out = self.step_fn(state, *inputs, lr)
        self.counts["eager"] += 1
        return self._vector(metrics), out

    def _capture(self, state, inputs):
        static_in = [torch.empty_like(x) for x in inputs]
        static_lr = torch.zeros((), dtype=torch.float32, device=inputs[0].device)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators(state):
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, stream=self.stream):
            metrics, out = self.step_fn(state, *static_in, static_lr)
            vec = self._vector(metrics)
        self.graph, self._static = graph, (static_in, static_lr, vec, out)
        self.counts["captured"] += 1

    def step(self, state, inputs, lr, eager=False):
        """One step on the device tensors ``inputs``: (its metrics as a
        vector in ``keys`` order, out). A replay's vector and out are the
        graph's buffers, which the next replay overwrites."""
        dev = inputs[0].device
        if dev.type != "cuda":
            return self._eager(state, inputs, lr)
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        caller = torch.cuda.current_stream(dev)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            if (self.graph is None and not eager and self.counts["eager"] >= self.warmup
                    and self.ready(state)):
                self._capture(state, inputs)
            if self.graph is None or eager:
                out = self._eager(state, inputs, lr)
            else:
                static_in, static_lr, vec, res = self._static
                for s, x in zip(static_in, inputs):
                    s.copy_(x)
                static_lr.fill_(lr)
                self.graph.replay()
                self.counts["replayed"] += 1
                out = vec, res
        caller.wait_stream(self.stream)
        return out

    def __call__(self, state, *args, eager=False):
        """``(state, *stacked, lr)``, each of ``stacked`` the (k, ...) stack
        of one batch argument: the k steps in order. Returns the (k, n)
        metrics of the steps, one row a step in ``keys`` order (JAX's
        "seq"), and the last step's out."""
        *stacked, lr = args
        k = stacked[0].shape[0]
        seq = out = None
        for i in range(k):
            vec, out = self.step(state, [b[i] for b in stacked], lr, eager)
            if seq is None:
                seq = vec.new_empty((k, vec.numel()))
            seq[i].copy_(vec)
        if self._static is not None and out is self._static[3]:
            out = out.clone()  # the graph's buffer: the next replay writes it
        return seq, out


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
        self.image_paths = []
        self._metrics = {}
        self._host_metrics = None
        self._last_epoch = 0  # LambdaLR's last_epoch
        self.resume_position = None  # a preempted run's position, from its checkpoint
        self.lr = getattr(opt, "lr", 0.0)
        # the plateau policy's state (torch ReduceLROnPlateau semantics);
        # not checkpointed, as in the JAX package: a resume starts it afresh
        self._plateau_best = float("inf")
        self._plateau_bad = 0
        self._plateau_scale = 1.0
        # the data axis shards the fixed-size training batch; eval batches are
        # ragged (no drop_last), so inference takes the spatial axis alone, as
        # in JAX
        self.mesh = resolve_mesh(getattr(opt, "data_axis", 0) if self.isTrain else 1,
                                 getattr(opt, "spatial_axis", 1),
                                 batch_size=getattr(opt, "batchSize", None) if self.isTrain
                                 else None, height=getattr(opt, "fineSize_h", None))
        if self.mesh is not None:
            d, s = self.mesh.shape
            print(f"mesh: data={d} x spatial={s} (data row {self.mesh.rank}, "
                  f"image rows {self.mesh.row} of {s})")

    def _local(self, arr):
        """This rank's rows (and strip of image rows) of a host NHWC global
        batch (all of it without a mesh)."""
        return arr if self.mesh is None else shard_batch(arr, self.mesh)

    def _on_mesh(self, *nets):
        """Put the networks on the mesh (nothing without one): BatchNorm's
        statistics over the global batch, the parameters and buffers
        broadcast from rank 0."""
        if self.mesh is not None:
            for net in nets:
                set_batchnorm_mesh(net, self.mesh)
            replicate(nets, self.mesh)

    def _place_batch(self, arr):
        """A host NHWC batch on the device. On the card the copy leaves from
        pinned memory without blocking the host. uint8 batches travel raw,
        a quarter of the bytes; the step normalizes them."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _place_stack(self, arrays):
        """``np.stack(arrays)`` on the device in one copy: on the card the
        arrays are stacked straight into pinned memory, so the host moves
        their bytes once before the copy."""
        first = np.asarray(arrays[0])
        host = torch.empty((len(arrays), *first.shape), dtype=torch.from_numpy(first).dtype,
                           pin_memory=self.device.type == "cuda")
        np.stack(arrays, out=host.numpy())
        return host.to(self.device, non_blocking=True)

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

    def eval(self):
        """Put the networks in eval mode (reference base_model.py:48-52):
        dropout off, BatchNorm on its running statistics. The eval build of
        G is already in it."""
        for net in self._networks().values():
            net.eval()
        self.is_eval = True

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

    def use_metrics(self, metrics):
        """Make ``metrics`` (one step's dict of 0-d tensors, e.g. a chunk's
        ``_metrics_seq`` entry) the metrics the getters report."""
        if metrics is not self._metrics:
            self._metrics, self._host_metrics = metrics, None

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
        state = self._checkpoint_state()  # every rank: it may gather over the mesh
        if multihost.is_primary():  # the metrics are the mesh's: every rank raises
            os.makedirs(dump_dir, exist_ok=True)
            ckpt.save_state(self.save_dir, "anomaly", state)
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
        inputs, the first image fetched from the device for the rest; on a
        spatial axis each joined from the row group's strips (every rank
        calls this)."""
        rows = self.mesh is not None and self.mesh.spatial > 1
        out = OrderedDict()
        for name in self.visual_names:
            val = getattr(self, name + "_host", None)
            if val is None:
                val = getattr(self, name, None)
                if isinstance(val, torch.Tensor):
                    val = val[:1]
                    val = (gather_image_rows(val.contiguous(), self.mesh, dim=1) if rows
                           else val).cpu()
            elif rows:
                val = gather_image_rows(np.ascontiguousarray(val[:1]), self.mesh, dim=1)
            if val is not None:
                out[name] = tensor2im(val)
        return out

    def print_networks(self, verbose=False):
        """Each network's parameter count (reference base_model.py:
        150-160); ``verbose`` prints the modules too."""
        for name, net in self._networks().items():
            if verbose:
                print(net)
            n = sum(p.numel() for p in net.parameters())
            print("[Network %s] Total number of parameters : %.3f M" % (name, n / 1e6))

    def _networks(self):
        """The model's networks by name."""
        return {}

    # -- persistence -------------------------------------------------------
    def _checkpoint_state(self):
        raise NotImplementedError

    def _load_checkpoint_state(self, state):
        raise NotImplementedError

    def save_networks(self, which_epoch, extra=None):
        """Save the full state as the ``which_epoch`` checkpoint (rank 0
        writes it, the other ranks wait); ``extra``: more entries for it
        (the train CLI's run position at a preemption)."""
        state = dict(self._checkpoint_state(), **(extra or {}))
        if multihost.is_primary():
            path = ckpt.save_state(self.save_dir, which_epoch, state)
            print(f"saved checkpoint: {path}")
            k = int(getattr(self.opt, "keep_ckpts", 0) or 0)
            if k > 0:
                ckpt.keep_latest(self.save_dir, k)
        if self.mesh is not None:
            comms.barrier(self.mesh)  # every rank may load it from here on

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
