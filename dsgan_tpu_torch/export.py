"""The serving artifact: the generator exported with its weights baked in
(port of ``dsgan_tpu/export.py``).

``export_generator`` traces the serving function with ``torch.export``:
uint8 NHWC pixels in -> /255*2-1 -> generator -> clip/quantize -> uint8
NHWC pixels out (the train/eval contract, ``ops.metrics``), with the batch
dimension symbolic where the graph allows it. The weights are the
program's constants: serving needs no checkpoint and no model class, only
``load_artifact``, which imports the op library so that the graph's
``dsgan::block_core`` / ``dsgan::block_core2`` nodes resolve. On the card
they launch K1 at c1-c5 and K3 at uc1-uc4, as the live serving function
does; on the CPU they run the plain versions. One artifact runs on both
(``meta["platforms"]``): it is moved to the device it is loaded on.

``quantize="w8"`` stores every eligible weight as int8 with per-channel f32
scales (``quant.py``) and dequantizes it inside the graph at every call.

CLI (the eval CLI's options, plus):

    python -m dsgan_tpu_torch.export --name X --which_epoch N --out g.pt2
        [--export_batch B] [--float_io] [--quantize w8 [--quant_tol T]]
        [--load_npz g.npz] [--platform cpu]

writes ``g.pt2`` (``torch.export.save``) and ``g.pt2.json`` (the I/O
contract). Without a card it raises unless ``--platform cpu``.
"""

import argparse
import copy
import json
import os
import sys

import numpy as np
import torch
from torch import nn

from dsgan_tpu_torch.device import resolve_device
from dsgan_tpu_torch.ops.metrics import normalize_u8, psnr_uint8, quantize_uint8, ssim_uint8
from dsgan_tpu_torch.quant import Quantized, quantize_params, transposed_weights

PLATFORMS = ["cuda", "cpu"]
MAX_BATCH = 4096  # the symbolic batch's upper bound


class _ServingModule(nn.Module):
    """x -> G -> y on a frozen copy of ``netG``: uint8 NHWC in and out with
    ``uint8_io``, else float NHWC in [-1, 1] in and unbounded float NHWC
    out. The copy is the serving build (``registry.serving_build``).

    ``quantize="w8"``: the copy's eligible parameters are replaced by int8
    buffers with f32 scales, quantized from the parameters as ``netG``
    holds them (f32 for a training build), and dequantized to f32 at every
    call; the layers cast them to their compute dtype at use."""

    def __init__(self, netG, uint8_io=True, quantize=None):
        super().__init__()
        from dsgan_tpu_torch.models.registry import serving_build

        if quantize not in (None, "", "w8"):
            raise ValueError(f"unknown quantize mode {quantize!r} (only 'w8')")
        net = copy.deepcopy(netG).eval().requires_grad_(False)
        self.uint8_io = bool(uint8_io)
        self.w8 = []  # (parameter name, buffer prefix)
        if quantize == "w8":
            qp = quantize_params(dict(net.named_parameters()), transposed=transposed_weights(net))
            for i, (name, leaf) in enumerate(qp.items()):
                if isinstance(leaf, Quantized):
                    prefix = f"w8_{i}"
                    self.register_buffer(prefix + "_q", leaf.q)
                    self.register_buffer(prefix + "_scale", leaf.scale)
                    mod_name, _, leaf_name = name.rpartition(".")
                    del net.get_submodule(mod_name)._parameters[leaf_name]
                    self.w8.append((name, prefix))
        self.net = serving_build(net)

    def _generator(self, x):
        if not self.w8:
            return self.net(x)
        weights = {name: getattr(self, p + "_q").float() * getattr(self, p + "_scale")
                   for name, p in self.w8}
        return torch.func.functional_call(self.net, weights, (x,), strict=False)

    def forward(self, x):
        y = self._generator(normalize_u8(x).permute(0, 3, 1, 2))
        if self.uint8_io:
            return quantize_uint8(y).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
        return y.permute(0, 2, 3, 1).contiguous()


def serving_module(netG, uint8_io=True, quantize=None):
    """The serving function of ``netG`` as a module (``_ServingModule``)."""
    return _ServingModule(netG, uint8_io, quantize)


def _device(net):
    return next(t for t in (*net.parameters(), *net.buffers())).device


def export_generator(netG, height, width, input_nc, batch=None, uint8_io=True, quantize=None):
    """``torch.export`` the serving function of ``netG`` on its device.
    ``batch=None`` tries a symbolic batch and, where the graph is not
    batch-polymorphic, says so in one line and fixes it at 1. Returns
    (program, meta); meta records the I/O contract for the sidecar."""
    mod = serving_module(netG, uint8_io, quantize)
    dev = _device(mod)
    in_dtype = torch.uint8 if uint8_io else torch.float32

    def example(b):
        return (torch.zeros((b, height, width, input_nc), dtype=in_dtype, device=dev),)

    poly = batch is None
    with torch.no_grad():
        if poly:
            try:
                dim = torch.export.Dim("batch", min=1, max=MAX_BATCH)
                program = torch.export.export(mod, example(2), dynamic_shapes=({0: dim},))
            except Exception as e:  # not batch-polymorphic: fix the batch
                print(f"symbolic-batch export unavailable ({type(e).__name__}); fixing batch=1")
                poly, batch = False, 1
        if not poly:
            program = torch.export.export(mod, example(batch))
    meta = {
        "input": (f"uint8 NHWC [{'b' if poly else batch},{height},{width},{input_nc}] raw pixels"
                  if uint8_io else "float NHWC in [-1,1]"),
        "output": "uint8 NHWC RGB" if uint8_io else "float NHWC, unbounded (no tanh)",
        "batch": "polymorphic" if poly else int(batch),
        "height": height, "width": width, "input_nc": input_nc,
        "platforms": list(PLATFORMS),
        "uint8_io": bool(uint8_io),
        "quantize": quantize or "none",
    }
    return program, meta


def save_artifact(path, program, meta):
    """Write the program (``torch.export.save``) and its ``.json`` sidecar."""
    torch.export.save(program, path)
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    return path


def load_artifact(path, device=None):
    """An artifact -> (callable, meta). The program is placed on ``device``
    (None: the card, raising without one; ``"cpu"`` only when asked). The
    callable maps an NHWC batch (numpy or tensor) to the output on that
    device, in inference mode."""
    import dsgan_tpu_torch.kernels.block_core  # noqa: F401  (registers the dsgan:: ops)

    dev = resolve_device(device)
    program = torch.export.load(path)
    held = {t.device.type for t in (*program.state_dict.values(), *program.constants.values())
            if isinstance(t, torch.Tensor)}
    if held != {dev.type}:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, dev)
    module = program.module()
    meta = {}
    if os.path.isfile(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)

    def call(x):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        with torch.inference_mode():
            return module(x.to(dev))

    return call, meta


def _quant_gate(netG, opt, ex):
    """The w8 quality gate: the float and the w8 serving functions on a probe
    batch (``default_rng(0)``), SSIM and PSNR between their uint8 outputs;
    with ``ex.quant_tol`` an SSIM below it ends the export."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (1, opt.fineSize_h, opt.fineSize_w, opt.input_nc), dtype=np.uint8)
    xt = torch.from_numpy(x).to(_device(netG))
    f_ref, f_q = serving_module(netG), serving_module(netG, quantize="w8")
    with torch.inference_mode():
        a, b = f_ref(xt), f_q(xt)
    a, b = (t.permute(0, 3, 1, 2).float() for t in (a, b))
    s, p = float(ssim_uint8(a, b)), float(psnr_uint8(a, b))
    print(f"quant gate: SSIM(w8, float) = {s:.4f}  PSNR = {p:.2f} dB  (tol {ex.quant_tol})")
    if ex.quant_tol and s < ex.quant_tol:
        raise SystemExit(f"--quantize w8 failed the quality gate: SSIM {s:.4f} < "
                         f"--quant_tol {ex.quant_tol}")
    return {"ssim": s, "psnr": p}


def main(argv=None, dataset_path=None, out_path=None):
    from dsgan_tpu_torch.models import create_model, registry
    from dsgan_tpu_torch.options.test_options import TestOptions

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--out", type=str, default="generator.pt2")
    pre.add_argument("--export_batch", type=int, default=0,
                     help="0: batch-polymorphic artifact (falls back to 1)")
    pre.add_argument("--float_io", action="store_true",
                     help="export the float [-1,1] contract instead of uint8")
    pre.add_argument("--quantize", type=str, default="", choices=["", "w8"],
                     help="w8: per-channel int8 weights in the artifact, dequantized at use")
    pre.add_argument("--quant_tol", type=float, default=0.0,
                     help="fail the export if SSIM(w8, float) on the probe batch is below this "
                          "(0 = report only)")
    ex, rest = pre.parse_known_args(argv)
    opt = TestOptions().parse(dataset_path, out_path, rest)

    model = create_model(opt)
    # the generator's f32 weights (and BatchNorm statistics) from the
    # checkpoint or the npz, into a training build: w8 quantizes f32
    # weights, as the JAX package does; the float artifact stores the
    # serving build's
    netG = registry.define_G(
        opt.input_nc, opt.output_nc, opt.ngf, opt.which_model_netG, norm=opt.norm,
        use_dropout=not opt.no_dropout, dtype=model.dtype, device=model.device,
        gelu_mode=opt.gelu, seed=opt.seed, train=True)
    netG.load_state_dict(model.generator_state(opt.which_epoch, npz=opt.load_npz))
    netG.eval()
    program, meta = export_generator(
        netG, opt.fineSize_h, opt.fineSize_w, opt.input_nc, batch=ex.export_batch or None,
        uint8_io=not ex.float_io, quantize=ex.quantize or None)
    if ex.quantize:
        meta["quant_gate"] = _quant_gate(netG, opt, ex)
    path = save_artifact(ex.out, program, meta)
    print(f"exported {os.path.getsize(path) / 1e6:.1f} MB artifact to {path}")
    print(json.dumps(meta))


if __name__ == "__main__":
    main(sys.argv[1:])
