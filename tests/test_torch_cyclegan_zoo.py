"""The port's CycleGAN step against the JAX package's on a zoo recipe, with
``tests/test_torch_cyclegan.py``'s helpers: resnet_6blocks G_A / G_B (ngf
8) under ``--norm batch`` with a BatchNorm PatchGAN (ndf 8), batch 2,
pools of 4, three steps from carried weights at f32. Every loss agrees to
1e-4 and the parameters as there; after the first step the running
statistics of all four nets agree to 1e-5, which holds the order of the
applications (the G pass moves D_A's and D_B's before their own update);
the third step meets full pools, whose swap draws are JAX's, handed to the
port's pools, and after it both pools hold JAX's images and counts."""

import numpy as np
import pytest
from test_torch_cyclegan import NETS, _run, check_losses, check_parameters

from dsgan_tpu_torch.utils.convert import flatten, jax_from_state_dict


@pytest.fixture(scope="module")
def run():
    return _run("resnet_batchnorm_pool")


def test_cyclegan_zoo_losses_match_jax(run):
    check_losses(run)


def test_cyclegan_zoo_parameters_match_jax(run):
    check_parameters(run)


def test_cyclegan_batchnorm_stats_match_jax(run):
    """Running statistics of all four nets after one step."""
    jstats, port = run["stats"][0]
    eg, ed = run["entries"]
    for net, entries, want, sd in zip(NETS, (eg, eg, ed, ed), jstats, port):
        full = dict(getattr(run["state"], net).state_dict(), **sd)
        _, got = jax_from_state_dict(full, entries)
        got, want = flatten(got), flatten(want)
        assert set(got) == set(want) and got, net
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=f"{net} {k}")
        assert any(not np.allclose(v, 0.0) and not np.allclose(v, 1.0) for v in got.values())


def test_cyclegan_pools_match_jax(run):
    """With JAX's draws, the port's pools hold JAX's images and counts."""
    state, js = run["state"], run["jstate"]
    for side in "AB":
        pool = getattr(state, f"pool_{side}")
        assert pool.count == int(getattr(js, f"pool_{side}_count")) == 4
        np.testing.assert_allclose(pool.images.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(getattr(js, f"pool_{side}_images")),
                                   rtol=1e-4, atol=1e-4)
    # the third step met full pools: its D losses (held above) ran on the swaps
    assert len(run["metrics"]) == 3
