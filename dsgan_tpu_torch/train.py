"""The training CLI (port of ``dsgan_tpu/train.py``, reference
DSGAN/train.py).

    python -m dsgan_tpu_torch.train --dataroot /path/to/data [flags]

The JAX CLI's flags and output: the epoch loop over the threaded loader,
a loss line and ``loss_log.txt``, a ``train_img/train_Re{epoch}_{i}.png``
triptych (TIR | fake | GT), ``result.csv`` every ``--print_freq`` steps,
``each_epoch.csv`` and a full-state checkpoint at the end of every epoch,
then the LR update. The step's metrics stay 0-d tensors on the device and
are copied over only at ``--print_freq``, all pending ones in one copy, so
the loop does not wait for the device in between. Runs on the CUDA card;
``--platform cpu`` runs the plain PyTorch path on the CPU.

The runtime flags:

- ``--steps_per_dispatch k``: the loader's batches go to the model in
  chunks of k, staged with one host-to-device copy; on the card the train
  step is captured in a CUDA graph once the replay pool is full and
  replayed once a batch (``Pix2PixModel.optimize_parameters_chunk``); the
  steps before, and an epoch's tail shorter than k, run eagerly. The
  printed losses and the histories are each step's own, the visuals the
  chunk's last batch. k = 1 runs every step eagerly.
- SIGTERM: at the next chunk boundary the full state is saved as the
  ``preempt`` checkpoint with the run's position (epoch, batches done, the
  loader's epoch start, the epoch's SSIM / PSNR so far), and the CLI exits
  0. ``--continue_train --which_epoch preempt`` with the same flags
  resumes there, on the same batches, and ends where an uninterrupted run
  ends.
- ``--profile_dir DIR --profile_steps start:stop``: a ``torch.profiler``
  trace (CPU, and the card's kernels) of the steps start..stop of this
  process (0-based, rounded out to chunk boundaries), written as
  ``DIR/trace_steps_{start}_{stop}.json``.
- ``--debug_nans``: autograd anomaly detection, which raises at the first
  backward that produces a NaN and names its forward op; the steps then
  run eagerly, one at a time, since anomaly mode and graph capture do not
  mix.

Exit code 3: ``--detect_anomaly`` found a NaN/Inf.
"""

import csv
import os
import signal
import sys
import threading
import time

import numpy as np
import torch
from PIL import Image

from dsgan_tpu_torch.data import CreateDataLoader
from dsgan_tpu_torch.models import create_model
from dsgan_tpu_torch.models.base_model import AnomalyDetected
from dsgan_tpu_torch.options.train_options import TrainOptions
from dsgan_tpu_torch.utils.visualizer import Visualizer


def _drain(model, ssim_hist, psnr_hist, start):
    """Replace the device scalars of both histories from ``start`` on with
    floats, fetched in one copy with the step's metrics."""
    k = len(ssim_hist) - start
    vals = model.fetch_metrics(ssim_hist[start:] + psnr_hist[start:])
    ssim_hist[start:], psnr_hist[start:] = vals[:k], vals[k:]
    return len(ssim_hist)


def _install_preempt_handler():
    """A SIGTERM flag (``dsgan_tpu/train.py:71-93``): the handler only
    records the request, and the epoch loop checkpoints at the next chunk
    boundary. Returns (the flag, a function that puts the previous handler
    back). Nothing is installed off the main thread, where Python does not
    take signal handlers."""
    flag = []
    if threading.current_thread() is not threading.main_thread():
        return flag, lambda: None
    previous = signal.signal(signal.SIGTERM, lambda sig, frame: flag.append(sig))
    return flag, lambda: signal.signal(signal.SIGTERM, previous)


class _StepProfiler:
    """``--profile_dir`` / ``--profile_steps``: a torch.profiler trace over
    the steps start..stop (``dsgan_tpu/train.py:123-129,169-173,235-239``)."""

    def __init__(self, opt, device):
        self.dir = opt.profile_dir
        self.start_step, self.stop_step = (
            (int(v) for v in opt.profile_steps.split(":")) if self.dir else (-1, -1))
        self.device = device
        self.prof = None

    def before(self, step, n):
        """Before the chunk of ``n`` steps that starts at ``step``."""
        if self.start_step >= 0 and step <= self.start_step < step + n and self.prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()

    def after(self, step, n):
        """After that chunk; ``step`` counts it."""
        if self.prof is not None and step - n < self.stop_step + 1 <= step:
            self.close()

    def close(self):
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"trace_steps_{self.start_step}_{self.stop_step}.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        print(f"profiler trace written to {path}")


def main(argv=None, dataset_path=None, out_path=None):
    """Train as the command line says. Returns the model and one row per
    step: (epoch, its LR, then host seconds: the wait for the loader, the
    step's share of its chunk's set_input + optimize_parameters, its
    print-frequency work)."""
    opt = TrainOptions().parse(dataset_path, out_path, argv)
    preempt, restore = _install_preempt_handler()
    try:
        with torch.autograd.set_detect_anomaly(bool(opt.debug_nans)):
            return _train(opt, out_path, preempt)
    finally:
        restore()


def _train(opt, out_path, preempt):
    output_freq = opt.print_freq
    result_path = out_path or os.path.join(opt.checkpoints_dir, opt.name)
    train_img_path = os.path.join(result_path, "train_img")
    os.makedirs(train_img_path, exist_ok=True)

    data_loader = CreateDataLoader(opt, "train")
    dataset = data_loader.load_data()
    dataset_size = len(data_loader)
    print("#training images = %d" % dataset_size)

    model = create_model(opt)
    model.setup(opt)
    visualizer = Visualizer(opt)
    profiler = _StepProfiler(opt, model.device)
    steps = []

    spd = max(1, int(opt.steps_per_dispatch))
    if opt.debug_nans:
        print("--debug_nans: autograd anomaly detection is on; the steps run eagerly, one at a "
              "time (anomaly mode and CUDA-graph capture do not mix)")
        spd = 1
    # a preempted run resumes where it stood: its epoch, on its batches
    position = model.resume_position
    first_epoch = opt.epoch_count
    if position is not None:
        first_epoch = position["epoch"]
        data_loader.resume_at(position["epoch_start"], position["batches"])
        print(f"resuming epoch {first_epoch} after its first {position['batches']} batches")
    global_step = 0

    total_epochs = opt.niter + opt.niter_decay
    try:
        for epoch in range(first_epoch, total_epochs + 1):
            epoch_start_time = time.time()
            ssim_hist, psnr_hist, i = [], [], -1
            if position is not None and epoch == position["epoch"]:
                ssim_hist, psnr_hist = list(position["ssim"]), list(position["psnr"])
                i = position["batches"] - 1
            n_fetched = len(ssim_hist)
            epoch_iter = (i + 1) * opt.batchSize

            batches = iter(dataset)
            while True:
                chunk, waits = [], []
                while len(chunk) < spd:
                    t0 = time.perf_counter()
                    data = next(batches, None)
                    if data is None:
                        break
                    waits.append(time.perf_counter() - t0)
                    chunk.append(data)
                if not chunk:
                    break
                if preempt:
                    n_fetched = _drain(model, ssim_hist, psnr_hist, n_fetched)
                    print(f"SIGTERM received: checkpointing 'preempt' state (epoch {epoch}, "
                          f"iter {i + 1}) and exiting")
                    model.save_networks("preempt", extra={"run": dict(
                        epoch=epoch, batches=i + 1, epoch_start=data_loader.epoch_start,
                        ssim=ssim_hist, psnr=psnr_hist)})
                    print("resume with: --continue_train --which_epoch preempt")
                    batches.close()
                    return model, steps

                profiler.before(global_step, len(chunk))
                t1 = time.perf_counter()
                if spd > 1:
                    model.set_input_chunk(chunk)
                    model.optimize_parameters_chunk()
                    seq = model._metrics_seq
                else:
                    model.set_input(chunk[0])
                    model.optimize_parameters()
                    seq = [model._metrics]
                dispatch = (time.perf_counter() - t1) / len(chunk)

                for j, m in enumerate(seq):
                    t2 = time.perf_counter()
                    # 0-d device tensors, kept as they are: no wait here
                    ssim_hist.append(m["ssim"])
                    psnr_hist.append(m["psnr"])
                    i += 1
                    epoch_iter += opt.batchSize
                    global_step += 1
                    if (i + 1) % output_freq == 0:
                        model.use_metrics(m)
                        n_fetched = _drain(model, ssim_hist, psnr_hist, n_fetched)
                        ssim_avg, psnr_avg = float(np.mean(ssim_hist)), float(np.mean(psnr_hist))
                        losses = model.get_current_losses()
                        if opt.detect_anomaly:
                            model.check_anomaly(f"epoch {epoch} iter {i + 1}")
                        visualizer.print_current_losses(
                            epoch, epoch_iter, losses,
                            (time.perf_counter() - t1) / (opt.batchSize * len(chunk)), waits[j],
                            ssim_avg, psnr_avg)
                        # the triptych (a chunk's: its last batch)
                        vis = model.get_current_visuals()
                        trip = np.hstack([vis["real_A"], vis["fake_B"], vis["real_B"]])
                        Image.fromarray(trip).save(
                            os.path.join(train_img_path, f"train_Re{epoch}_{i + 1}.png"))
                        with open(os.path.join(result_path, "result.csv"), "a", newline="") as f:
                            message = "".join(f"{k}: {v:.3f} " for k, v in losses.items()) + "  "
                            csv.writer(f).writerow([epoch, message, ssim_avg, psnr_avg])
                    steps.append((epoch, model.lr, waits[j], dispatch, time.perf_counter() - t2))
                model.use_metrics(seq[-1])
                profiler.after(global_step, len(chunk))

            _drain(model, ssim_hist, psnr_hist, n_fetched)
            ssim_avg = float(np.mean(ssim_hist)) if ssim_hist else 0.0
            psnr_avg = float(np.mean(psnr_hist)) if psnr_hist else 0.0
            with open(os.path.join(result_path, "each_epoch.csv"), "a", newline="") as f:
                csv.writer(f).writerow([epoch, "train", ssim_avg, psnr_avg])

            print("saving the model at the end of epoch %d" % epoch)
            if opt.detect_anomaly:
                # a poisoned state is not saved as an epoch checkpoint
                model.check_anomaly(f"epoch {epoch} end")
            model.save_networks(epoch)
            print("End of epoch %d / %d \t Time Taken: %d sec"
                  % (epoch, total_epochs, time.time() - epoch_start_time))
            model.update_learning_rate()
    finally:
        profiler.close()
    return model, steps


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    except AnomalyDetected as e:
        print(f"FATAL: {e}", file=sys.stderr)
        sys.exit(3)
