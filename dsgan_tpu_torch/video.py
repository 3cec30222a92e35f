"""Video colorization evaluation (port of ``dsgan_tpu/video.py``): the
generator over an ordered frame directory in batches, and temporal
consistency.

    python -m dsgan_tpu_torch.video --dataroot <frames_dir> --name exp \
        --which_epoch 20 [--gt_dir <rgb_frames>] [--batchSize 8]

Frames are read in sorted filename order, resized to --fineSize with PIL
bicubic and mapped to f32 in [-1, 1] (a one-channel --input_nc takes the
training datasets' luma mix). The generator is the serving build, in eval
mode and inference mode, so every MixConvNeXtML block runs the registered
K1 / K3 ops on the card; its weights come from the port's train
checkpoint: a pix2pix ``netG`` or a cycle_gan ``netG_A``, BatchNorm
running statistics included.

``temporal.csv`` (under results_dir/name/video/) holds the JAX CLI's rows:
per frame the mean |y_t - y_{t-1}| and |x_t - x_{t-1}| and, unless
--no_flow_metric, the flow-warped errors (``ops/flow.py``: LK flow on the
input pair, the previous output warped along it); then the flow-free
ratio TC = mean |dy| / mean |dx|, the mean flow-warped errors, and with
--gt_dir the uint8 SSIM / PSNR against the ground truth and, with
--inception_weights, FID / KID of the outputs against it. Runs on the
CUDA card; --platform cpu runs on the CPU.

With --num_hosts N (one process a card) the data axis shards each
batch of frames, padded to --batchSize, over the ranks
(``dsgan_tpu/video.py:120-150``): each rank infers its rows, the outputs
are gathered, and rank 0 scores them and writes ``temporal.csv``; the
other ranks return None. With --spatial_axis S each rank of a row group
infers its strip of the frames' rows (``parallel.spatial``) and the
strips are joined before the rows are.
"""

import csv
import os
import sys

import numpy as np
import torch

from dsgan_tpu_torch.options.test_options import TestOptions


class VideoOptions(TestOptions):
    def initialize(self, parser):
        parser = TestOptions.initialize(self, parser)
        parser.add_argument("--gt_dir", type=str, default="",
                            help="optional directory of paired ground-truth RGB frames (same "
                                 "sorted order) for SSIM/PSNR")
        parser.add_argument("--no_flow_metric", action="store_true",
                            help="skip the motion-compensated (optical-flow warped) "
                                 "temporal-consistency metric")
        return parser


def _frame_paths(d):
    from dsgan_tpu_torch.data.image_folder import IMG_EXTENSIONS

    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if any(f.lower().endswith(e) for e in IMG_EXTENSIONS))


def _load_frames(paths, h, w, nc=3):
    """Frames -> (N, h, w, nc) f32 in [-1, 1]; nc 1 takes the luma mix."""
    from PIL import Image

    from dsgan_tpu_torch.data.transforms import rgb_to_gray

    if nc not in (1, 3):
        raise SystemExit(f"video harness supports input_nc 1 or 3, got {nc}")
    out = np.empty((len(paths), h, w, nc), np.float32)
    for i, p in enumerate(paths):
        img = Image.open(p).convert("RGB").resize((w, h), Image.BICUBIC)
        arr = np.asarray(img, np.float32) / 255.0 * 2.0 - 1.0
        out[i] = rgb_to_gray(arr) if nc == 1 else arr
    return out


def load_generator(opt, device):
    """The serving-build generator of --which_model_netG with the weights
    of the --which_epoch train checkpoint (``netG``, or cycle_gan's
    ``netG_A``)."""
    from dsgan_tpu_torch.models import define_G
    from dsgan_tpu_torch.utils import checkpoint as ckpt

    dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
    g = define_G(opt.input_nc, opt.output_nc, opt.ngf, opt.which_model_netG, norm=opt.norm,
                 use_dropout=not opt.no_dropout, dtype=dtype, device=device,
                 gelu_mode=opt.gelu)
    save_dir = os.path.join(opt.checkpoints_dir, opt.name)
    which = opt.which_epoch
    if which == "latest":
        which = ckpt.latest_epoch(save_dir)
    st = ckpt.restore_state(save_dir, which)
    key = next((k for k in ("netG", "netG_A") if k in st), None)
    if key is None:
        raise SystemExit(f"checkpoint epoch {which} has no generator (keys: {sorted(st)})")
    g.load_state_dict(st[key])
    print(f"loaded generator {key} from epoch {which}")
    return g


def main(argv=None):
    """Evaluate the frames as the command line says; returns the TC ratio
    (None on a rank other than 0)."""
    from dsgan_tpu_torch import ops
    from dsgan_tpu_torch.device import platform_device
    from dsgan_tpu_torch.ops import flow as flow_ops
    from dsgan_tpu_torch.parallel import gather_batch, multihost, resolve_mesh, spatial

    opt = VideoOptions().parse(argv=argv)
    opt.isTrain = False
    device = platform_device(opt.platform)
    paths = _frame_paths(opt.dataroot)
    if len(paths) < 2:
        raise SystemExit(f"need >=2 frames in {opt.dataroot}, found {len(paths)}")
    h, w, nc = opt.fineSize_h, opt.fineSize_w, int(opt.input_nc)
    bs = max(int(opt.batchSize), 1)
    mesh = resolve_mesh(opt.data_axis, opt.spatial_axis, batch_size=bs, height=h)
    g = load_generator(opt, device)
    x_all = _load_frames(paths, h, w, nc)
    ys = []
    with torch.inference_mode():
        for i in range(0, len(paths), bs):
            x = x_all[i:i + bs]
            n = len(x)
            if mesh is not None:  # pad to the batch the mesh shards, drop after
                x = np.concatenate([x, np.zeros((bs - n, h, w, nc), np.float32)])[mesh.rows(bs)]
                x = x[:, mesh.strip(h)]  # and this rank's image rows
            # the generator casts the f32 frames to its compute dtype
            with spatial.rows(mesh):
                y = g(torch.from_numpy(np.ascontiguousarray(x)).to(device).permute(0, 3, 1, 2))
            y = y.permute(0, 2, 3, 1)
            if mesh is not None:
                y = gather_batch(y.float().contiguous(), mesh)[:n]
            ys.append(y.float().cpu().numpy())
    y = np.concatenate(ys)
    if not multihost.is_primary():
        return None

    dy = np.mean(np.abs(y[1:] - y[:-1]))
    dx = np.mean(np.abs(x_all[1:] - x_all[:-1]))
    tc = float(dy / max(dx, 1e-8))

    warp_out = warp_in = None
    if not opt.no_flow_metric:
        warp_out, warp_in = [], []
        xt, yt = torch.from_numpy(x_all).to(device), torch.from_numpy(y).to(device)
        for t in range(1, len(paths)):
            fl = flow_ops.estimate_flow(xt[t - 1], xt[t])
            eo, ei = flow_ops.flow_warped_error(yt[t - 1], yt[t], xt[t - 1], xt[t], fl)
            warp_out.append(float(eo))
            warp_in.append(float(ei))

    results_dir = os.path.join(opt.results_dir, opt.name, "video")
    os.makedirs(results_dir, exist_ok=True)
    hdr = ["frame", "d_prev_out", "d_prev_in"]
    if warp_out is not None:
        hdr += ["warp_err_out", "warp_err_in"]
    rows = [hdr]
    for t in range(1, len(paths)):
        row = [os.path.basename(paths[t]), float(np.mean(np.abs(y[t] - y[t - 1]))),
               float(np.mean(np.abs(x_all[t] - x_all[t - 1])))]
        if warp_out is not None:
            row += [warp_out[t - 1], warp_in[t - 1]]
        rows.append(row)

    ssim_mean = psnr_mean = fid_val = kid_val = None
    if opt.gt_dir:
        gt_paths = _frame_paths(opt.gt_dir)
        if len(gt_paths) != len(paths):
            raise SystemExit(f"gt/input frame counts differ: {len(gt_paths)} / {len(paths)}")
        gt = _load_frames(gt_paths, h, w, int(opt.output_nc))
        yq = ops.quantize_uint8(torch.from_numpy(y).to(device).permute(0, 3, 1, 2))
        gq = ops.quantize_uint8(torch.from_numpy(gt).to(device).permute(0, 3, 1, 2))
        ssim_mean = float(ops.ssim_uint8(gq, yq))
        psnr_mean = float(ops.psnr_uint8(gq, yq))
        if opt.inception_weights:
            from dsgan_tpu_torch.models.inception import make_feature_accumulators
            from dsgan_tpu_torch.ops import fid as fid_ops

            new_acc = make_feature_accumulators(opt.inception_weights, device=device)
            acc_y, acc_g = new_acc(), new_acc()
            for t in range(len(paths)):
                acc_y.add(y[t])
                acc_g.add(gt[t])
            ff, fr = acc_y.result(), acc_g.result()
            fid_val = fid_ops.fid_from_features(ff, fr)
            kid_val, _ = fid_ops.kid_from_features(ff, fr, subset_size=min(len(ff), 100))

    with open(os.path.join(results_dir, "temporal.csv"), "w", newline="") as f:
        wtr = csv.writer(f)
        wtr.writerows(rows)
        wtr.writerow([])
        wtr.writerow(["temporal_consistency_ratio", tc])
        if warp_out is not None:
            wtr.writerow(["flow_warped_err_out", float(np.mean(warp_out))])
            wtr.writerow(["flow_warped_err_in", float(np.mean(warp_in))])
        if ssim_mean is not None:
            wtr.writerow(["mean_ssim", ssim_mean])
            wtr.writerow(["mean_psnr", psnr_mean])
        if fid_val is not None:
            wtr.writerow(["fid", fid_val])
            wtr.writerow(["kid", kid_val])

    msg = f"frames: {len(paths)}  temporal-consistency ratio: {tc:.4f}"
    if warp_out is not None:
        msg += (f"  flow-warped err out/in: "
                f"{float(np.mean(warp_out)):.4f}/{float(np.mean(warp_in)):.4f}")
    if ssim_mean is not None:
        msg += f"  mean SSIM: {ssim_mean:.4f}  mean PSNR: {psnr_mean:.3f}"
    if fid_val is not None:
        msg += f"  FID: {fid_val:.3f}"
    print(msg)
    print(f"wrote {os.path.join(results_dir, 'temporal.csv')}")
    return tc


if __name__ == "__main__":
    main(sys.argv[1:])
