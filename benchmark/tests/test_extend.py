"""A later change adds a configuration (here one with another
discriminator, and so its own plain reference), a traffic mix, a cell and
a per-layer metric as new files and ``BENCHMARK.json`` entries alone: the
harness finds each by its name, and no file that is there is edited."""

import hashlib
import json
import shutil

import torch

from benchmark import run as bench_run

PIXEL_REFERENCE = '''"""pix2pix with the per-pixel discriminator (``--which_model_netD
pixel``): 1x1 convs of ndf, 2 ndf (InstanceNorm) and 1 channels, LeakyReLU
0.2."""

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import pix2pix, steps
from benchmark.reference.nets import MixConvNeXtML, Net, Vgg16Taps, instance_norm

TRAINED, LOSSES, SERVED = pix2pix.TRAINED, pix2pix.LOSSES, pix2pix.SERVED
KERNEL_LEAVES, counted_step = pix2pix.KERNEL_LEAVES, pix2pix.counted_step


class PixelGAN(Net):
    def __init__(self, input_nc, ndf):
        super().__init__()
        self.conv0 = nn.Conv2d(input_nc, ndf, 1)
        self.conv1 = nn.Conv2d(ndf, 2 * ndf, 1)
        self.conv2 = nn.Conv2d(2 * ndf, 1, 1)

    def forward(self, x):
        x = F.leaky_relu(self._conv(x, self.conv0.weight, self.conv0.bias), 0.2)
        x = self._conv(x, self.conv1.weight, self.conv1.bias)
        x = F.leaky_relu(instance_norm(x), 0.2)
        return self._conv(x, self.conv2.weight, self.conv2.bias)


def build_nets(opts, device):
    steps.require(opts, which_model_netG="MixConvNeXtML", ngf=32, which_model_netD="pixel",
                  norm="instance")
    with torch.device(device):
        return {"G": MixConvNeXtML(), "D": PixelGAN(6, opts["ndf"]), "vgg": Vgg16Taps()}


class Trainer(pix2pix.Trainer):
    pass
'''


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_config_reference_and_metric_as_files(tiny_root, tmp_path):
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "dsgan_pix2pix.json").read_text())
    cfg["options"]["which_model_netD"] = "pixel"
    cfg["reference"] = "pix2pix_pixel"
    (bench / "configs" / "pix2pix_pixel.json").write_text(json.dumps(cfg))
    (bench / "reference" / "pix2pix_pixel.py").write_text(PIXEL_REFERENCE)
    (bench / "workloads" / "train_b2_new.json").write_text(json.dumps(
        {"kind": "train", "why": "a mix added later", "batch": 2, "distinct_batches": 3,
         "steps_per_dispatch": 2, "trace_chunks": 1, "reference_micro": 2}))
    (bench / "limits" / "pixel-train").with_suffix(".json").write_text(json.dumps(
        {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2, "replay_loss_gap": 1e-3,
         "replay_change_gap": 1e-2}))
    (bench / "metrics" / "traced_steps.py").write_text(
        '"""Steps in the traced stretch."""\n\nLAYER = "model shell"\nMOVES = "train_img_per_s"\n'
        'UNIT = "steps"\n\n\ndef read(run):\n    return float(run["traced_units"])\n')
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "pix2pix_pixel", "source": "a test",
                            "file": "benchmark/configs/pix2pix_pixel.json", "reduced": [],
                            "why": "a configuration added later"})
    spec["workloads"].append({"name": "pixel-train", "config": "pix2pix_pixel",
                              "traffic": "train_b2_new", "chips": 1, "why": "added later"})
    for m in spec["end_to_end"]:
        if "workloads" in m and m["name"] == "train_img_per_s":
            m["workloads"].append("pixel-train")
    spec["per_layer"].append({"name": "traced_steps", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "model shell",
                              "moves": "train_img_per_s", "workloads": ["pixel-train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())  # nothing there was edited

    args = bench_run.parse(["--workload", "pixel-train", "--seed", "3000000047",
                            "--seconds", "0.5", "--trace", "1"])
    res = bench_run.execute(args, torch.device("cpu"), root=root)
    assert res["metrics"]["traced_steps"] == {"value": 2.0, "unit": "steps"}
    assert res["correct"] is True, res["checks"]
    assert res["where"]["leaves"] > res["where"]["leaves_compared"] > 0
    args.trace = 0
    res = bench_run.execute(args, torch.device("cpu"), root=root)
    assert set(res["metrics"]) == {"train_img_per_s", "peak_mem_gib", "setup_s"}
    assert list(res)[-1] == "checks"
