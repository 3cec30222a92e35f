"""The plain reference against the port's CPU path at 32 x 32, float32: the
networks on one set of seeded weights; the first step of pix2pix and of
CycleGAN, and a chunk from a state part way through with the replay pools
full, driven through the benchmark's own driver code."""

import re
import statistics

import pytest
import torch

from benchmark import common, correct
from benchmark.drivers import train
from benchmark.reference import pix2pix

CPU = torch.device("cpu")
OPTS = {"which_model_netG": "MixConvNeXtML", "ngf": 32, "which_model_netD": "basic",
        "norm": "instance", "ndf": 32, "n_layers_D": 3}


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_networks_match_the_port():
    from dsgan_tpu_torch.models import define_D, define_G, define_vgg

    shapes = pix2pix.build_nets(OPTS, "meta")
    w = common.seeded_weights(shapes, 3000000041, CPU)
    ref = pix2pix.build_nets(OPTS, CPU)
    for key, net in ref.items():
        net.load_state_dict(w[key])
    port = {"G": define_G(3, 3, 32, "MixConvNeXtML", dtype=torch.float32, device=CPU, train=True),
            "D": define_D(6, 32, "basic", dtype=torch.float32, device=CPU),
            "vgg": define_vgg(4, dtype=torch.float32, device=CPU)}
    for key, net in port.items():
        net.load_state_dict(w[key])
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(5)) * 2 - 1
    with torch.no_grad():
        assert _rel(port["G"](x), ref["G"](x)) < 1e-5
        xy = torch.cat([x, x.flip(0)], 1)
        assert _rel(port["D"](xy), ref["D"](xy)) < 1e-5
        for a, b in zip(port["vgg"](x), ref["vgg"](x)):
            assert _rel(a, b) < 1e-5


@pytest.mark.parametrize("cell", ["pix2pix-train-b16", "cyclegan-train-b16"])
def test_first_step_matches_the_port(tiny_root, cell):
    """Step 1's losses within 1e-5, and the first gradient within 1e-3 on
    every leaf whose norm is a tenth of its network's median or more (the
    others, such as a bias in front of an InstanceNorm, are round-off)."""
    c = common.load_cell(cell, tiny_root)
    prog = train.Program(c, 3000000043, CPU)
    first = prog.first_steps()
    ref, _ = train.reference(c, 3000000043, CPU, prog.side_a, prog.side_b, first["ids"])
    for k, v in ref["losses"][0].items():
        assert abs(first["losses"][0][k] - v) <= 1e-5 * abs(v), k
    norms = {k: float(g.norm()) for k, g in ref["grads"].items()}
    for net in {k.split(".")[0] for k in norms}:
        names = [k for k in norms if k.split(".")[0] == net]
        med = statistics.median(norms[k] for k in names)
        for k in names:
            if norms[k] >= 0.1 * med:
                assert _rel(first["grads"][k], ref["grads"][k]) < 1e-3, k


@pytest.mark.parametrize("cell", ["pix2pix-train-b16", "cyclegan-train-b16"])
def test_checked_chunk_matches_the_port(tiny_root, cell):
    """From the copied state, with the pools full, the reference meets the
    same pool picks: each step's losses within 1e-5, the median leaf's
    change within 1e-4, and each kernel leaf's change within 1e-3 (the
    local stream's leaves, whose gradients are mostly the rounding of
    cancelling sums, miss by up to 0.8 in float32 on both sides)."""
    c = common.load_cell(cell, tiny_root)
    prog = train.Program(c, 3000000059, CPU)
    first = prog.first_steps()
    while any(pool.count < pool.pool_size for pool in prog.pools):
        prog.chunk(2)
    checked = prog.checked_chunk(2)
    assert all(count == c.config["options"]["pool_size"]
               for _, count, _ in checked["state"]["pools"])
    ref = train.follow(c, 3000000059, CPU, prog.side_a, prog.side_b, first, checked)
    kernel = common.reference_module(c).KERNEL_LEAVES
    numbers, _ = correct.train_numbers(first, checked, ref, kernel)
    assert numbers["replay_loss_gap"] < 1e-5
    assert numbers["replay_change_gap"] < 1e-4
    init = checked["state"]["params"]
    for k in filter(re.compile(kernel).match, init):
        assert _rel(checked["params"][k] - init[k], ref["chunk"]["params"][k] - init[k]) < 1e-3, k
