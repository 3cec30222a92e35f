"""The port's video CLI (``python -m dsgan_tpu_torch.video``) end to end on
the CPU against the JAX package: a generator checkpoint written by the
port (a pix2pix ``netG``, or a cycle_gan ``netG_A``; resnet_6blocks at ngf
8, f32), 6 frames of a moving scene stored at 40x36 and resized to 32x32.
The JAX side runs the same carried weights through its generator on the
frames as ``dsgan_tpu/video.py`` loads them, and its ``ops/flow.py`` on
each pair: the TC ratio, every frame's differences and flow-warped errors
and their means equal ``temporal.csv``'s at rel 1e-4; the SSIM / PSNR
rows against --gt_dir within 1e-3 (uint8 levels of two f32 programs);
with --inception_weights the FID / KID rows are written (the FID a
stand-in sum of the features: its arithmetic is tests/test_torch_fid.py's)."""

import contextlib
import csv
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dsgan_tpu import ops as jops
from dsgan_tpu import video as jax_video
from dsgan_tpu.models import define_G as jax_define_G
from dsgan_tpu.models.pix2pix import _apply_net
from dsgan_tpu.ops import flow as jflow
from dsgan_tpu_torch import video
from dsgan_tpu_torch.ops import fid as tfid
from dsgan_tpu_torch.models import define_G, registry
from dsgan_tpu_torch.utils import checkpoint as ckpt
from dsgan_tpu_torch.utils.convert import jax_from_state_dict

NGF, N = 8, 6


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Frames of a smooth scene moving 1 pixel right and down a frame, and
    a ground-truth directory (the same scene's other channels order)."""
    root = tmp_path_factory.mktemp("video")
    yy, xx = np.mgrid[0:36, 0:40].astype(np.float32)
    for d in ("frames", "gt"):
        (root / d).mkdir()
    for t in range(N):
        img = np.stack([np.sin(0.3 * (xx - t) + c) * np.cos(0.25 * (yy - t) - c)
                        for c in (0.0, 1.0, 2.0)], -1)
        u8 = ((img + 1) * 127.5).astype(np.uint8)
        Image.fromarray(u8).save(root / "frames" / f"f_{t:02d}.png")
        Image.fromarray(u8[..., ::-1].copy()).save(root / "gt" / f"g_{t:02d}.png")
    return root


def _checkpoint(root, key):
    g = define_G(3, 3, NGF, "resnet_6blocks", dtype=torch.float32, device="cpu", seed=9,
                 train=True)
    ckpt.save_state(str(root / "c" / key), 1, {key: g.state_dict()})
    return g.state_dict()


def _jax_reference(sd, frame_dir):
    entries = registry.generator_entries(3, 3, NGF, "resnet_6blocks")
    params = jax.tree_util.tree_map(jnp.asarray, jax_from_state_dict(sd, entries)[0])
    g = jax_define_G(3, 3, NGF, "resnet_6blocks", "instance", dtype=None, inference=True)
    paths = sorted(str(p) for p in frame_dir.iterdir())
    x = jax_video._load_frames(paths, 32, 32)
    y = np.asarray(jax.jit(lambda p, v: _apply_net(g, p, v, False))(params, jnp.asarray(x)))
    pair = jax.jit(lambda xp, xc, yp, yc: jflow.flow_warped_error(
        yp, yc, xp, xc, jflow.estimate_flow(xp, xc)))
    warps = np.array([[float(v) for v in pair(x[t - 1], x[t], y[t - 1], y[t])]
                      for t in range(1, N)])
    rows = [[np.mean(np.abs(y[t] - y[t - 1])), np.mean(np.abs(x[t] - x[t - 1])), *warps[t - 1]]
            for t in range(1, N)]
    tc = np.mean(np.abs(y[1:] - y[:-1])) / np.mean(np.abs(x[1:] - x[:-1]))
    return dict(rows=rows, tc=tc, warp=warps.mean(0), y=y)


@pytest.mark.parametrize("key", ["netG", "netG_A"])
def test_video_cli_matches_jax_flow_metrics(frames, key, monkeypatch):
    sd = _checkpoint(frames, key)
    argv = ["--platform", "cpu", "--dtype", "float32", "--dataroot", str(frames / "frames"),
            "--name", key, "--checkpoints_dir", str(frames / "c"), "--which_epoch", "1",
            "--which_model_netG", "resnet_6blocks", "--ngf", str(NGF), "--no_dropout",
            "--fineSize_w", "32", "--fineSize_h", "32", "--batchSize", "4",
            "--results_dir", str(frames / "r"), "--gt_dir", str(frames / "gt")]
    if key == "netG_A":
        argv += ["--inception_weights", "random"]
        # the FID's ~20 s matrix square root on the CPU stands in for a sum
        # of the features (its arithmetic: tests/test_torch_fid.py)
        monkeypatch.setattr(tfid, "fid_from_features",
                            lambda ff, fr: float(np.sum(ff) - np.sum(fr)))
    with contextlib.redirect_stdout(io.StringIO()):
        tc = video.main(argv)
    want = _jax_reference(sd, frames / "frames")
    lines = list(csv.reader(open(frames / "r" / key / "video" / "temporal.csv")))
    assert lines[0] == ["frame", "d_prev_out", "d_prev_in", "warp_err_out", "warp_err_in"]
    body = [[float(v) for v in r[1:]] for r in lines[1:N]]
    np.testing.assert_allclose(body, want["rows"], rtol=1e-4)
    assert [r[0] for r in lines[1:N]] == [f"f_{t:02d}.png" for t in range(1, N)]
    tail = {r[0]: float(r[1]) for r in lines[N + 1:]}
    assert tc == pytest.approx(want["tc"], rel=1e-4)
    assert tail["temporal_consistency_ratio"] == pytest.approx(want["tc"], rel=1e-4)
    assert tail["flow_warped_err_out"] == pytest.approx(want["warp"][0], rel=1e-4)
    assert tail["flow_warped_err_in"] == pytest.approx(want["warp"][1], rel=1e-4)
    gt = jax_video._load_frames(sorted(str(p) for p in (frames / "gt").iterdir()), 32, 32)
    yq, gq = (jops.metrics.quantize_uint8(jnp.asarray(v)) for v in (want["y"], gt))
    assert tail["mean_ssim"] == pytest.approx(float(jops.ssim_uint8(gq, yq)), abs=1e-3)
    assert tail["mean_psnr"] == pytest.approx(float(jops.psnr_uint8(gq, yq)), rel=1e-3)
    if key == "netG_A":
        assert np.isfinite(tail["fid"]) and np.isfinite(tail["kid"])
    else:
        assert "fid" not in tail


def test_video_cli_refuses_sharding_and_a_missing_card(frames):
    # the rows of a U-Net over two ranks, asked of one process
    with pytest.raises(ValueError, match="exceeds the 1 visible devices"):
        video.main(["--dataroot", str(frames / "frames"), "--spatial_axis", "2",
                    "--which_model_netG", "unet_128", "--checkpoints_dir", str(frames / "c"),
                    "--platform", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--platform cpu"):
            video.main(["--dataroot", str(frames / "frames"), "--checkpoints_dir",
                        str(frames / "c")])
