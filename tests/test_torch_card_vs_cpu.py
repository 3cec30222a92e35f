"""The card_vs_cpu phase's comparison (``chip_smoke.cvc_compare``) on the
CPU lane: both sides on the CPU, the second in contiguous memory where the
port's step keeps channels_last (``pix2pix.CL``; the zoo's layers then run
on what they are given), at small sizes. A clean pair reads under the
phase's limit; a planted average-pool gradient fault and a planted conv
forward fault on one side are each caught and named; the eval ops hold in
channels_last memory; the phase's recipes cover every generator and
discriminator of the registry, every norm and every model. No JAX, no
spawn."""

from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from dsgan_tpu_torch.models import pix2pix, registry
from dsgan_tpu_torch.ops import conv

LIMIT = chip_smoke.CARD_VS_CPU["limit"]


@pytest.fixture(autouse=True)
def _two_threads():
    """Two CPU threads a test: the lane runs six workers on the machine's
    cores, and these steps slow by tens of times when each worker takes
    them all."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _contiguous():
    """The step's images in contiguous memory, not channels_last."""
    return [mock.patch.object(pix2pix, "CL", torch.contiguous_format)]


def _wrong_pool_gradient():
    """``ops.pool_avg`` with its forward right and its input gradient that
    of the pool one column over: a layout fault of the kind torch's own
    overlapping pool shows on channels_last CUDA memory."""
    def pool(x, window, stride, padding, count_include_pad):
        y = F.avg_pool2d(x, window, stride, padding, count_include_pad=count_include_pad)
        off = F.avg_pool2d(x.roll(1, 3), window, stride, padding,
                           count_include_pad=count_include_pad)
        return off + (y - off).detach()
    return [mock.patch.object(conv, "pool_avg", pool)]


def _conv_forward_gain():
    """Every ``F.conv2d`` output times 1 + 2e-2 in the forward alone, its
    gradient unchanged: the card's ``forward_gain`` plant on any device."""
    conv2d = F.conv2d

    def gained(x, *args, **kw):
        y = conv2d(x, *args, **kw)
        return y + 2e-2 * y.detach()
    return [mock.patch.object(F, "conv2d", gained)]


@pytest.mark.parametrize("recipe,size", [("gll_multi", 64), ("cycle_unet_multi", 128)])
def test_cpu_pair_in_two_layouts_reads_under_the_limit(recipe, size):
    line, read, dist = chip_smoke.cvc_compare(torch, np, recipe, "cpu", size, 1, ngf=8,
                                              patches=_contiguous())
    assert not line["over"], line["over"]
    assert line["readings"] == len(read) == len(dist) > 40
    assert all(k.startswith(("loss.", "module.", "grad.", "output.", "out_grad.")) for k in read)
    # every module call's forward is read, in every network
    modules = {k.split(".")[1] for k in read if k.startswith("module.")}
    assert line["modules"]["count"] > 40
    assert modules == {k.split(".")[1] for k in read if k.startswith("grad.")}
    assert 1.0 <= line["divisors"]["largest"] <= chip_smoke.CARD_VS_CPU["cap"]
    assert set(line["losses"]) == {f"loss.{k}" for k in chip_smoke.SP_GATE_KEYS[recipe]}
    # one output and one cotangent a generator application: 1 for pix2pix,
    # 3 a generator for CycleGAN
    calls = 6 if chip_smoke.RECIPES[recipe][0] == "cycle_gan" else 1
    assert len(line["outputs"]) == 2 * calls
    # gradients that are 0 in exact arithmetic are listed and read against
    # their network's norm, not dropped
    assert line["null"] and all(read[k] <= LIMIT for k in line["null"])
    assert all(k.startswith("grad.") and k not in line["worst"] for k in line["null"])


def test_planted_average_pool_fault_is_caught_and_named():
    line, read, _ = chip_smoke.cvc_compare(torch, np, "gll_multi", "cpu", 64, 1, ngf=8,
                                           patches=_contiguous() + _wrong_pool_gradient())
    over = line["over"]
    # the multiscale D's pools hand gll a wrong cotangent; each stage reads
    # on the reference's inputs, so the gate names that cotangent, and D's
    # own gradients (its pools act on its input) stay clean
    assert read["out_grad.netG.0"] >= 10 * LIMIT
    assert set(over) == {"out_grad.netG.0"}, over


def test_planted_conv_forward_fault_is_caught_in_each_network():
    line, read, _ = chip_smoke.cvc_compare(torch, np, "gll_multi", "cpu", 64, 1, ngf=8,
                                           patches=_contiguous() + _conv_forward_gain())
    # each module runs on the reference's inputs, so every conv module of
    # gll and of the multiscale D reads the gain itself; the SSIM loss's
    # window conv reads it in the loss and its cotangent, and no parameter
    # gradient moves (the gain leaves each backward as it was)
    for net in ("netG", "netD"):
        assert max(v for k, v in read.items() if k.startswith(f"module.{net}.")) >= 10 * LIMIT
    assert not [k for k in line["over"] if k.startswith("grad.")], line["over"]


def test_card_plants_are_inert_on_the_cpu():
    """The card's planted faults (a transposed conv's weight gradient, a
    conv's forward output) act on CUDA tensors alone (gll and the
    multiscale D here, the cheapest)."""
    plants = [p for fault in ("transposed_gain", "forward_gain")
              for p in chip_smoke._cvc_plant(torch, fault)]
    line, _, _ = chip_smoke.cvc_compare(torch, np, "gll_multi", "cpu", 64, 1, ngf=8,
                                        patches=plants)
    assert not line["over"], line["over"]


def test_eval_ops_hold_in_channels_last_memory():
    """The eval ops on the CPU, one side's image batches in channels_last
    memory (their convs, pools and resizes then take other kernels)."""
    read, values = chip_smoke.cvc_eval_ops(torch, np, "cpu", size=192,
                                           layout=torch.channels_last)
    assert set(read) == {"ssim_uint8", "psnr_uint8", "ms_ssim", "ssim_5d", "estimate_flow",
                         "flow_warped_error", "resize_bilinear", "vgg_tap0", "vgg_tap1",
                         "vgg_tap2", "vgg_tap3"}
    assert all(v <= LIMIT for v in read.values()), read
    assert 0 < values["ssim_uint8"] < 1 and len(values["ms_ssim"]) == 2


def test_a_loose_floor_divides_by_the_cap_at_most():
    """A reading whose floor f32 resolves only to 1e-2 is divided by the
    cap (10), not by 1e3: a module output and a gradient each 1 off read
    over 10x the limit (the gradient by max-abs over its network's norm)."""
    cap = chip_smoke.CARD_VS_CPU["cap"]
    rng = np.random.default_rng(3)
    w, x = (torch.from_numpy(rng.standard_normal(n).astype(np.float32)) for n in (64, 256))

    def side(gw, gx):
        return dict(metrics={}, outs={}, cots={}, mods={"netG.conv": [gx]},
                    grads={"netG": {"weight": gw}})

    want = side(w, x)
    floor = side(w * (1 + 1e-2), x * (1 + 1e-2))
    got = side(2 * w, 2 * x)
    read, dist, nulls, div, capped = chip_smoke.cvc_readings(torch, got, want, floor, ())
    assert nulls == ["grad.netG.weight"]
    assert set(capped) == set(read) and all(v == cap for v in div.values())
    assert read["module.netG.conv.0"] == pytest.approx(1 / cap)
    assert min(read.values()) >= 10 * LIMIT


def test_recipes_cover_every_network_norm_and_model():
    recipes = [chip_smoke.RECIPES[r] for r in chip_smoke.CVC_RECIPES]
    assert {g for _, g, _, _ in recipes} - {None} == set(registry.GENERATORS)
    assert {d for _, _, d, _ in recipes} - {None} == set(registry.DISCRIMINATORS)
    assert {n for _, _, _, n in recipes} - {None} == {"instance", "batch", "none"}
    assert {m for m, _, _, _ in recipes} == {"pix2pix", "cycle_gan", "diffusion"}
    assert set(chip_smoke.CVC_RECIPES) <= set(chip_smoke.SP_GATE_KEYS)
    for recipe, _ in chip_smoke.CVC_FAULTS.values():
        assert recipe in chip_smoke.CVC_RECIPES
