"""The eval CLI (port of ``dsgan_tpu/test.py``): the generator alone over
the test set, per-image and mean SSIM / PSNR / MS-SSIM under the
reference protocol, an HTML gallery and ``metrics.csv``; with
``--inception_weights`` (a torchvision Inception3 npz, or ``random``) also
FID / KID of the fakes against the targets, as ``fid`` / ``kid`` rows and
on the summary line.

    python -m dsgan_tpu_torch.test --dataroot /path --which_epoch N [flags]

The generator is the serving build (its parameters stored in the compute
dtype, cast once on load) with its weights from the train checkpoint
``--which_epoch`` or from a JAX-layout params ``.npz`` (``--load_npz``);
``--model cycle_gan`` loads G_A and G_B and scores fake_B = G_A(real_A)
against real_B; ``--model diffusion`` scores a DDIM sample of its
denoiser (``--sample_steps``, seeded with the checkpoint's step).
MS-SSIM and the Inception features run on the model's device. Runs on the
CUDA card; ``--platform cpu`` runs the plain PyTorch path on the CPU. The
eval runs in one process, or with ``--spatial_axis S`` in S (``--num_hosts
S``), each running the generator on its strip of the image rows, the
images joined on every rank and rank 0 alone writing the results, as JAX's
``_jit_infer`` runs the spatial axis alone for inference.
"""

import csv
import os
import sys
import time

import numpy as np
import torch

from dsgan_tpu_torch import ops
from dsgan_tpu_torch.data import CreateDataLoader
from dsgan_tpu_torch.models import create_model
from dsgan_tpu_torch.options.test_options import TestOptions
from dsgan_tpu_torch.parallel import multihost
from dsgan_tpu_torch.utils import html
from dsgan_tpu_torch.utils.visualizer import save_images


def _nchw(img, device):
    """HWC uint8 -> (1, C, H, W) float32 on ``device``."""
    return torch.from_numpy(img).to(device).permute(2, 0, 1)[None].float()


def main(argv=None, dataset_path=None, out_path=None):
    """Evaluate as the command line says. Returns the model and the
    per-image rows, each with its host milliseconds from set_input to the
    saved images."""
    opt = TestOptions().parse(dataset_path, out_path, argv)
    if multihost.process_count() > max(int(opt.spatial_axis or 1), 1):
        raise NotImplementedError("the eval CLI runs in one process, or one a strip with "
                                  "--spatial_axis: its batches are ragged, and the data axis "
                                  "shards the training batch only")
    primary = multihost.is_primary()
    opt.nThreads = 1
    opt.serial_batches = True
    opt.no_flip = True

    data_loader = CreateDataLoader(opt, "test")
    dataset = data_loader.load_data()
    model = create_model(opt)
    if opt.load_npz:
        model.load_generator_npz(opt.load_npz)
        print(f"loaded generator weights from {opt.load_npz}")
    else:
        model.setup(opt)

    web_dir = os.path.join(opt.results_dir, opt.name, f"{opt.phase}_{opt.which_epoch}")
    webpage = html.HTML(
        web_dir, f"Experiment = {opt.name}, Phase = {opt.phase}, Epoch = {opt.which_epoch}") \
        if primary else None

    rows = []
    acc_fake = acc_real = None
    if opt.inception_weights:
        from dsgan_tpu_torch.models.inception import make_feature_accumulators

        new_acc = make_feature_accumulators(opt.inception_weights, device=model.device)
        acc_fake, acc_real = new_acc(), new_acc()
    for i, data in enumerate(dataset):
        if i >= opt.how_many:
            break
        t0 = time.perf_counter()
        model.set_input(data)
        model.test()
        # the JAX CLI's three images, whatever else the model shows
        visuals = {k: v for k, v in model.get_current_visuals().items()
                   if k in ("real_A", "fake_B", "real_B")}
        row = {"path": data["A_paths"][0], "index": i}
        if "real_B" in visuals:
            real, fake = visuals["real_B"], visuals["fake_B"]
            row["ssim"] = ops.ssim_ref(real, fake)
            row["psnr"] = ops.psnr_ref(real, fake)
            if min(real.shape[:2]) > 160:  # MS-SSIM needs > (win - 1) * 16 pixels
                row["ms_ssim"] = float(ops.ms_ssim(_nchw(real, model.device),
                                                   _nchw(fake, model.device), data_range=255))
            if acc_fake is not None:
                acc_fake.add(fake)
                acc_real.add(real)
        if primary:
            save_images(webpage, visuals, data["A_paths"], aspect_ratio=opt.aspect_ratio)
        row["ms"] = (time.perf_counter() - t0) * 1e3
        rows.append(row)
    if not primary:
        return model, rows
    webpage.save()

    fid_val = kid_val = kid_std = None
    if acc_fake is not None:
        ff, fr = acc_fake.result(), acc_real.result()
        if min(len(ff), len(fr)) >= 2:
            from dsgan_tpu_torch.ops import fid as fid_ops

            fid_val = fid_ops.fid_from_features(ff, fr)
            kid_val, kid_std = fid_ops.kid_from_features(
                ff, fr, subset_size=min(len(ff), len(fr), 100))
        else:
            print("skipping FID/KID: need >= 2 evaluated pairs")

    scored = [r for r in rows if "ssim" in r]
    ms_vals = [r["ms_ssim"] for r in rows if "ms_ssim" in r]
    with open(os.path.join(web_dir, "metrics.csv"), "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["index", "path", "ssim", "psnr", "ms_ssim"])
        for r in rows:
            writer.writerow([r["index"], r["path"], r.get("ssim", ""), r.get("psnr", ""),
                             r.get("ms_ssim", "")])
        if scored:
            writer.writerow(["mean", "", np.mean([r["ssim"] for r in scored]),
                             np.mean([r["psnr"] for r in scored]),
                             np.mean(ms_vals) if ms_vals else ""])
        if fid_val is not None:
            writer.writerow(["fid", "", fid_val, "", ""])
            writer.writerow(["kid", "", kid_val, kid_std, ""])
    print(f"wrote {len(rows)} results to {web_dir}")
    if scored:
        line = "mean SSIM: %.4f  mean PSNR: %.3f" % (np.mean([r["ssim"] for r in scored]),
                                                     np.mean([r["psnr"] for r in scored]))
        if ms_vals:
            line += "  mean MS-SSIM: %.4f" % float(np.mean(ms_vals))
        if fid_val is not None:
            line += "  FID: %.3f  KID: %.5f" % (fid_val, kid_val)
        print(line)
    return model, rows


if __name__ == "__main__":
    main(sys.argv[1:])
