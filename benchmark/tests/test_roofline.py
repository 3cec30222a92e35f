"""The work counts against values worked out by hand at a small site."""

import pytest
import torch

from benchmark import roofline
from benchmark.reference.nets import Block


def test_fwd_work_by_hand():
    # B 2, HW 4x4, C 8, P 16: GEMMs 2*32*(4*64 + 4*128 + 128) = 57344 FLOPs;
    # bytes: rows 32*(16 + 16)*2, weights (256 + 512 + 128 + 32 + 16)*2, stats 2*2*8*4
    flops, nbytes = roofline.fwd_work(2, 16, 8, 16, "bfloat16")
    assert flops == 57344
    assert nbytes == 32 * 32 * 2 + 944 * 2 + 128


def test_bwd_work_by_hand():
    # 2*32*(8*64 + 10*128) = 114688: no recomputed hidden (that would add 8*32*64)
    flops, nbytes = roofline.bwd_work(2, 16, 8, 16, "bfloat16")
    assert flops == 114688
    weights = 256 + 512 + 128 + 32
    assert nbytes == (32 * 32 * 2 + 32 * 16 * 2 + weights * 2 + 4 * (weights + 16)
                      + 4 * 2 * 8 * 4)


def test_bound_takes_the_larger():
    assert roofline.bound_s(989e12, 1.0, "bfloat16") == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 3.35e12, "bfloat16") == pytest.approx(1.0)
    assert roofline.bound_s(67e12, 1.0, "float32") == pytest.approx(1.0)


def test_count_step_of_one_block():
    """FlopCounterMode over one reference block: the depthwise conv, the two
    linears and the shortcut, 2 FLOPs a multiply-add; and its site."""
    b, c, p, h = 2, 8, 16, 4
    blk = Block(c, p).to("meta")
    x = torch.empty(b, c, h, h, device="meta")
    flops, sites = roofline.count_step(lambda: blk(x))
    rows = b * h * h
    assert flops == 2 * rows * (49 * c + 4 * c * c + 4 * c * p + c * p)
    assert sites == [(b, h * h, c, p)]


def test_sites_bound_sums_the_calls():
    sites = [(2, 16, 8, 16), (1, 64, 4, 4)]
    want = sum(roofline.bound_s(*roofline.fwd_work(*s, "bfloat16"), "bfloat16") for s in sites)
    assert roofline.sites_bound_s(sites, "fwd", "bfloat16") == pytest.approx(want)
