"""Training traffic: a closed loop of train steps through the model shell's
chunk entry, as the train CLI calls it (``create_model``, ``setup``, then
per chunk ``set_input_chunk`` and ``optimize_parameters_chunk``), without
its loader, printing or checkpoints.

The configuration names its plain reference (``reference/<reference>.py``:
the networks, the trainer, the trained networks and the losses) and where
the program keeps its networks, optimizers and pools (``program``), so
that this module names no recipe.

Set-up builds the model from the configuration's options, loads the seeded
weights, makes ``distinct_batches`` seeded uint8 batches per side and runs
the first three steps as chunks of one (eager, the pool filling, through
the same call), keeping what the check compares: each step's losses, the
first gradient as Adam's state holds it, the parameters after the third
step. Warm-up then runs chunks of ``steps_per_dispatch`` until the replay
pool is full and a chunk has replayed the captured CUDA graph. One more
chunk is the checked replay: the state before it (the trained weights,
Adam's moments and step counts, the pools' images, fill counts and
generator states) is copied to the host, and the chunk's steps' losses and
the parameters after it are kept. The window runs chunks, one in flight
while the host stages the next, until ``--seconds`` have passed, and ends
at the sync after its last step.

Once the window has closed and the program is freed, the reference
follows the first three steps from the seeded weights, and the checked
chunk from the copied state, on the same batches and, from the copied
generator states, the same pool picks.
"""

import itertools
import math
import shutil
import time

import torch

from benchmark import common, correct


def _argv(cell, seed, device):
    argv = ["--name", "bench", "--seed", str(int(seed) % (2 ** 31)),
            "--batchSize", str(cell.traffic["batch"]),
            "--steps_per_dispatch", str(cell.traffic["steps_per_dispatch"])]
    for k, v in cell.config["options"].items():
        argv += [f"--{k}", str(v)]
    if device.type == "cpu":
        argv += ["--platform", "cpu"]
    return argv


def _host(t):
    return t.detach().float().cpu().clone()


class Program:
    """The model shell built from the cell's options, with the seeded
    weights, and the cell's seeded batches; ``chunk(size)`` stages the next
    ``size`` batches and runs them through the chunk entry."""

    def __init__(self, cell, seed, device):
        from dsgan_tpu_torch.models import create_model
        from dsgan_tpu_torch.options.train_options import TrainOptions

        self.opts, tr = cell.config["options"], cell.traffic
        self.ref = common.reference_module(cell)
        self.batch = tr["batch"]
        h, w = self.opts["fineSize_h"], self.opts["fineSize_w"]
        tmp = common.scratch_dir()
        opt = TrainOptions().parse(path=tmp, argv=_argv(cell, seed, device))
        self.model = create_model(opt)
        self.model.setup(opt)
        shutil.rmtree(tmp, ignore_errors=True)
        where = cell.config["program"]
        self.nets = {k: common.attribute(self.model, p) for k, p in where["nets"].items()}
        self.optimizers = [common.attribute(self.model, p) for p in where["optimizers"]]
        self.pools = [common.attribute(self.model, p) for p in where["pools"]]
        shapes = self.ref.build_nets(self.opts, "meta")
        for key, state in common.seeded_weights(shapes, seed, device).items():
            self.nets[key].load_state_dict(state)
        self.n = tr["distinct_batches"]
        self.side_a = common.seeded_images(self.n, self.batch, h, w, seed, 1, device)
        self.side_b = common.seeded_images(self.n, self.batch, h, w, seed, 2, device)
        self.order = itertools.count()

    def chunk(self, size):
        """The next ``size`` batches through the chunk entry; their ids."""
        ids = [next(self.order) % self.n for _ in range(size)]
        self.model.set_input_chunk([{"A": self.side_a[i], "B": self.side_b[i]} for i in ids])
        self.model.optimize_parameters_chunk()
        return ids

    def leaves(self):
        return {f"{k}.{n}": p for k in self.ref.TRAINED
                for n, p in self.nets[k].named_parameters()}

    def _adam_state(self, p):
        for opt in self.optimizers:
            if any(p is q for g in opt.param_groups for q in g["params"]):
                return opt.state.get(p, {})
        raise KeyError("no optimizer holds the parameter")

    def _losses(self):
        """Each step's losses of the last chunk, as the train CLI reads them
        (``_metrics_seq``, one step's metrics at a time)."""
        out = []
        for m in self.model._metrics_seq:
            self.model.use_metrics(m)
            cur = self.model.get_current_metrics()
            out.append({key: cur[key] for key in self.ref.LOSSES})
        return out

    def first_steps(self):
        """Steps 1-3 as chunks of one: their batch ids, each step's losses,
        the first gradient (from Adam's first moment after one step:
        exp_avg = (1 - beta1) g; nought where the optimizer holds no state
        for a leaf: it never stepped) and the parameters after the third
        step, on the host."""
        beta1 = self.opts["beta1"]
        prog = {"ids": [], "losses": []}
        for i in range(3):
            prog["ids"] += self.chunk(1)
            prog["losses"] += self._losses()
            if i == 0:
                grads = {}
                for k, p in self.leaves().items():
                    st = self._adam_state(p)
                    grads[k] = (_host(st["exp_avg"]) / (1.0 - beta1) if "exp_avg" in st
                                else torch.zeros(p.shape))
                prog["grads"] = grads
        prog["params"] = {k: _host(p) for k, p in self.leaves().items()}
        return prog

    def snapshot(self):
        """The training state on the host, as ``Trainer.load_state`` takes it."""
        adam = {}
        for k, p in self.leaves().items():
            st = self._adam_state(p)  # empty for a leaf that never stepped
            zero = torch.zeros(p.shape)
            adam[k] = {"step": float(st.get("step", 0.0)),
                       "exp_avg": _host(st["exp_avg"]) if "exp_avg" in st else zero,
                       "exp_avg_sq": _host(st["exp_avg_sq"]) if "exp_avg_sq" in st else zero}
        return {"params": {k: _host(p) for k, p in self.leaves().items()}, "adam": adam,
                "pools": [(_host(pool.images), pool.count, pool.generator.get_state())
                          for pool in self.pools]}

    def checked_chunk(self, size):
        """One chunk from a copied state: the state, the batch ids, each
        step's losses and the parameters after it; and how many of its
        steps replayed the captured graph."""
        state = self.snapshot()
        counts = getattr(getattr(self.model, "_chained", None), "counts", {})
        replayed = counts.get("replayed", 0)
        ids = self.chunk(size)
        return {"state": state, "ids": ids, "losses": self._losses(),
                "params": {k: _host(p) for k, p in self.leaves().items()},
                "replayed": counts.get("replayed", 0) - replayed}


def reference(cell, seed, device, side_a, side_b, ids, state=None, precision=None,
              images=None):
    """The reference's steps on the batches ``ids``, from the seeded weights
    or, given ``state``, from that training state: {"losses", "grads",
    "params"} on the host, and the trained parameters it started from.
    ``precision``: the control's (``nets.Float8``); ``images``: run only the
    first ``images`` of each batch."""
    from benchmark.reference.nets import set_precision

    ref = common.reference_module(cell)
    opts = cell.config["options"]
    common.plain_precision()
    nets = ref.build_nets(opts, device)
    weights = common.seeded_weights(ref.build_nets(opts, "meta"), seed, device)
    for key, net in nets.items():
        net.load_state_dict(weights[key])
        if precision is not None:
            set_precision(net, precision)
    del weights
    trainer = ref.Trainer(nets, opts, micro=cell.traffic["reference_micro"])
    if state is not None:
        trainer.load_state(state)
    init = {k: _host(p) for k, p in trainer.named_parameters().items()}
    rows = slice(0, images)
    out = {"losses": [trainer.step(torch.from_numpy(side_a[i][rows]).to(device),
                                   torch.from_numpy(side_b[i][rows]).to(device))
                      for i in ids]}
    out["grads"] = {k: _host(g) for k, g in trainer.first_grads.items()}
    out["params"] = {k: _host(p) for k, p in trainer.named_parameters().items()}
    del trainer, nets
    common.free(device)
    return out, init


def follow(cell, seed, device, side_a, side_b, first, checked, **kw):
    """The reference's readings beside the program's: the first three steps
    from the seeded weights and the checked chunk from its copied state."""
    start, init = reference(cell, seed, device, side_a, side_b, first["ids"], **kw)
    chunk, chunk_init = reference(cell, seed, device, side_a, side_b, checked["ids"],
                                  state=checked["state"], **kw)
    return {"start": start, "start_init": init, "chunk": chunk, "chunk_init": chunk_init}


def warm_up(prog, k):
    """After the first three steps, chunks of ``k`` until the replay pool is
    full and a chunk has replayed the captured graph."""
    pool = prog.opts["pool_size"]
    fill = math.ceil(pool / prog.batch) if pool > 0 else 0
    for _ in range(math.ceil(max(0, fill - 3) / k) + 1):
        prog.chunk(k)


def run(cell, seed, seconds, trace, device, clock0):
    tr = cell.traffic
    k = tr["steps_per_dispatch"]
    prog = Program(cell, seed, device)
    common.reset_peak(device)
    first = prog.first_steps()
    warm_up(prog, k)
    checked = prog.checked_chunk(k)
    common.sync(device)

    pending, steps_done = None, 0
    t0 = time.perf_counter()
    while True:
        prog.chunk(k)
        steps_done += k
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            if pending is not None:
                pending.synchronize()
            pending = event
        if time.perf_counter() - t0 >= seconds:
            break
    common.sync(device)
    window_s = time.perf_counter() - t0
    setup_s = t0 - clock0

    traced = None
    if trace:
        _, traced = common.traced(lambda: [prog.chunk(k) for _ in range(tr["trace_chunks"])],
                                  device)
    info = common.device_info(device)
    side_a, side_b, batch, opts = prog.side_a, prog.side_b, prog.batch, prog.opts
    del prog
    common.free(device)
    numbers, where = correct.train_numbers(
        first, checked, follow(cell, seed, device, side_a, side_b, first, checked),
        common.reference_module(cell).KERNEL_LEAVES)
    where["checked_chunk_replayed_steps"] = checked["replayed"]
    flops, sites = count(cell, batch)
    return dict(
        kind="train", attempted=steps_done, failed=0, info=info, numbers=numbers, where=where,
        end_to_end={"train_img_per_s": steps_done * batch / window_s,
                    "peak_mem_gib": info["memory_peak_bytes"] / 2 ** 30, "setup_s": setup_s},
        units=steps_done, window_s=window_s, trace=traced, traced_units=tr["trace_chunks"] * k,
        flops_per_unit=flops, fwd_sites=sites, bwd_sites=sites, dtype=opts["dtype"])


def count(cell, batch):
    """Model FLOPs of one step and its block-core calls, over the
    reference on the meta device."""
    from benchmark import roofline

    ref, opts = common.reference_module(cell), cell.config["options"]
    nets = ref.build_nets(opts, "meta")
    a = torch.empty(batch, 3, opts["fineSize_h"], opts["fineSize_w"], device="meta")
    return roofline.count_step(lambda: ref.counted_step(nets, opts, a, a.clone()))
