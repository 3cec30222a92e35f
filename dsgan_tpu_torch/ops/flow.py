"""Dense pyramidal Lucas-Kanade optical flow and flow-compensated warping
(port of ``dsgan_tpu/ops/flow.py``), plain torch on one frame pair: the
video harness's motion-compensated temporal consistency
(``dsgan_tpu_torch/video.py``).

Conventions (the JAX package's):
  * images are (H, W) or (H, W, C) tensors; a flow is (H, W, 2), with
    flow[..., 0] = du (x / column displacement) and flow[..., 1] = dv (y /
    row);
  * a flow maps the target grid into the source frame: warp(src, flow)[p]
    = src[p + flow[p]] ~= tgt[p], so ``estimate_flow(src, tgt)`` is the
    flow that pulls src onto tgt.
"""

import torch
import torch.nn.functional as F

from dsgan_tpu_torch.ops.resize import resize_bilinear

_LUMA = (0.299, 0.587, 0.114)  # ITU-R 601


def _to_luma(img):
    """(H, W) | (H, W, 1) | (H, W, 3) -> (H, W) luma."""
    if img.dim() == 2:
        return img
    if img.shape[-1] == 1:
        return img[..., 0]
    return img @ torch.tensor(_LUMA, dtype=img.dtype, device=img.device)


def _box(x, win):
    """Same-size box average over a win x win window of an (H, W) map: the
    window sum over zero padding of win // 2 before and win - 1 - win // 2
    after (asymmetric for an even window), over win * win."""
    lo, hi = win // 2, win - 1 - win // 2
    s = F.avg_pool2d(F.pad(x[None, None], (lo, hi, lo, hi)), win, stride=1)
    return s[0, 0]


def _half(x):
    """2x downsample of an (H, W) map (2x2 mean; odd tails dropped)."""
    h2, w2 = x.shape[0] // 2, x.shape[1] // 2
    return x[:2 * h2, :2 * w2].reshape(h2, 2, w2, 2).mean(dim=(1, 3))


def warp_bilinear(img, flow):
    """``img`` sampled at (grid + flow), bilinear, each of the four taps'
    indices clamped to the edge (``map_coordinates(order=1,
    mode="nearest")``, summed in its order). img: (H, W) or (H, W, C);
    flow: (H, W, 2) in pixels. out[p] = img[p + flow[p]]."""
    h, w = img.shape[0], img.shape[1]
    yy, xx = torch.meshgrid(torch.arange(h, dtype=flow.dtype, device=flow.device),
                            torch.arange(w, dtype=flow.dtype, device=flow.device),
                            indexing="ij")
    taps = []
    for coord, size in ((yy + flow[..., 1], h), (xx + flow[..., 0], w)):
        lower = torch.floor(coord)
        upper_w = coord - lower
        i = lower.long()
        taps.append([(i.clamp(0, size - 1), 1 - upper_w), ((i + 1).clamp(0, size - 1), upper_w)])
    out = None
    for iy, wy in taps[0]:
        for ix, wx in taps[1]:
            wgt = wy * wx
            term = (wgt[..., None] if img.dim() == 3 else wgt) * img[iy, ix]
            out = term if out is None else out + term
    return out


def _lk_refine(src, tgt, flow, win, iters, eps=1e-3):
    """``iters`` Lucas-Kanade updates of ``flow`` at one pyramid level
    ((H, W) luma), each clamped to +-1.5 pixels (the linearization's trust
    region)."""
    for _ in range(iters):
        src_w = warp_bilinear(src, flow)
        ix = (torch.roll(src_w, -1, 1) - torch.roll(src_w, 1, 1)) * 0.5
        iy = (torch.roll(src_w, -1, 0) - torch.roll(src_w, 1, 0)) * 0.5
        r = tgt - src_w
        a11 = _box(ix * ix, win) + eps
        a22 = _box(iy * iy, win) + eps
        a12 = _box(ix * iy, win)
        b1 = _box(ix * r, win)
        b2 = _box(iy * r, win)
        det = a11 * a22 - a12 * a12
        du = ((a22 * b1 - a12 * b2) / det).clamp(-1.5, 1.5)
        dv = ((a11 * b2 - a12 * b1) / det).clamp(-1.5, 1.5)
        flow = flow + torch.stack([du, dv], dim=-1)
    return flow


def estimate_flow(src, tgt, levels=4, win=9, iters=3):
    """Dense pyramidal LK flow pulling ``src`` onto ``tgt`` ((H, W[, C])
    float images on one scale): (H, W, 2) f32 in pixels. A level is added
    while its half still spans a window; each finer level starts from the
    coarser flow resized (``ops.resize``) and doubled."""
    src = _to_luma(torch.as_tensor(src).float())
    tgt = _to_luma(torch.as_tensor(tgt).float())
    pyr = [(src, tgt)]
    for _ in range(levels - 1):
        s, t = pyr[-1]
        if min(s.shape) // 2 < win:
            break
        pyr.append((_half(s), _half(t)))
    s, t = pyr[-1]
    flow = torch.zeros((*s.shape, 2), dtype=torch.float32, device=s.device)
    for s, t in reversed(pyr):
        if flow.shape[:2] != s.shape:
            flow = resize_bilinear(flow, s.shape, dims=(0, 1)) * 2.0
        flow = _lk_refine(s, t, flow, win, iters)
    return flow


def flow_warped_error(prev_out, cur_out, prev_in, cur_in, flow, alpha=50.0):
    """Motion-compensated temporal inconsistency of one frame pair: the
    previous output warped along the input motion against the current
    output, weighted by exp(-alpha * |warp(prev_in) - cur_in|^2) (the
    I2VGAN / vid2vid occlusion proxy). Returns 0-d tensors (err_out,
    err_in): the weighted mean |warp(prev_out) - cur_out| (over channels
    too) and the same on the inputs' luma, the floor the flow sets."""
    prev_out, cur_out = prev_out.float(), cur_out.float()
    w_in = warp_bilinear(_to_luma(prev_in.float()), flow)
    l_in = _to_luma(cur_in.float())
    wgt = torch.exp(-alpha * torch.square(w_in - l_in))
    w_out = warp_bilinear(prev_out, flow)
    d_out = (w_out - cur_out).abs()
    if d_out.dim() == 3:
        d_out = d_out.mean(dim=-1)
    denom = wgt.sum() + 1e-8
    return (wgt * d_out).sum() / denom, (wgt * (w_in - l_in).abs()).sum() / denom
