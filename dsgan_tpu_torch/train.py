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
``--platform cpu`` runs the plain PyTorch path on the CPU. Exit code 3:
``--detect_anomaly`` found a NaN/Inf.
"""

import csv
import os
import sys
import time

import numpy as np
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


def main(argv=None, dataset_path=None, out_path=None):
    """Train as the command line says. Returns the model and one row per
    step: (epoch, its LR, then host seconds: the wait for the loader,
    set_input + optimize_parameters, the print-frequency work)."""
    opt = TrainOptions().parse(dataset_path, out_path, argv)
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
    steps = []

    total_epochs = opt.niter + opt.niter_decay
    for epoch in range(opt.epoch_count, total_epochs + 1):
        epoch_start_time = time.time()
        ssim_hist, psnr_hist = [], []
        n_fetched = 0
        epoch_iter = 0
        t_data = 0.0

        batches = iter(dataset)
        i = -1
        while True:
            t0 = time.perf_counter()
            data = next(batches, None)
            if data is None:
                break
            t1 = time.perf_counter()
            if (i + 1) % output_freq == 0:
                t_data = t1 - t0
            model.set_input(data)
            model.optimize_parameters()
            # 0-d device tensors, kept as they are: no wait here
            m = model._metrics
            ssim_hist.append(m["ssim"])
            psnr_hist.append(m["psnr"])
            i += 1
            epoch_iter += opt.batchSize
            t2 = time.perf_counter()

            if (i + 1) % output_freq == 0:
                n_fetched = _drain(model, ssim_hist, psnr_hist, n_fetched)
                ssim_avg, psnr_avg = float(np.mean(ssim_hist)), float(np.mean(psnr_hist))
                losses = model.get_current_losses()
                if opt.detect_anomaly:
                    model.check_anomaly(f"epoch {epoch} iter {i + 1}")
                visualizer.print_current_losses(epoch, epoch_iter, losses,
                                                (time.perf_counter() - t1) / opt.batchSize,
                                                t_data, ssim_avg, psnr_avg)
                vis = model.get_current_visuals()
                trip = np.hstack([vis["real_A"], vis["fake_B"], vis["real_B"]])
                Image.fromarray(trip).save(
                    os.path.join(train_img_path, f"train_Re{epoch}_{i + 1}.png"))
                with open(os.path.join(result_path, "result.csv"), "a", newline="") as f:
                    message = "".join(f"{k}: {v:.3f} " for k, v in losses.items()) + "  "
                    csv.writer(f).writerow([epoch, message, ssim_avg, psnr_avg])
            steps.append((epoch, model.lr, t1 - t0, t2 - t1, time.perf_counter() - t2))

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
    return model, steps


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    except AnomalyDetected as e:
        print(f"FATAL: {e}", file=sys.stderr)
        sys.exit(3)
