"""The port's MixConvNeXtML against the JAX package's, on the CPU at f32,
with the same weights carried across, and the weight carry-over itself."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsgan_tpu.models import define_G as jax_define_G
from dsgan_tpu.utils.pth_convert import convert_mixconvnext, save_params_npz
from dsgan_tpu_torch.models import define_G, init_params
from dsgan_tpu_torch.utils.convert import flatten, load_params_npz, state_dict_from_jax

SEED = 3


@pytest.fixture(scope="module")
def params():
    return init_params(SEED)


@pytest.fixture(scope="module")
def jax_forward(params):
    """The JAX generator's jitted f32 forward, built once for this file."""
    g = jax_define_G(3, 3, 32, "MixConvNeXtML", dtype=None, inference=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    return jax.jit(lambda x: g.apply({"params": jparams}, x))


def test_state_dict_round_trips_through_the_jax_converter(params, tmp_path):
    """np.savez of the port's state_dict -> convert_mixconvnext gives back the
    JAX tree, leaf for leaf and bit for bit."""
    net = define_G(3, 3, 32, "MixConvNeXtML", dtype=torch.float32, device="cpu", params=params)
    npz = tmp_path / "g_torch.npz"
    np.savez(npz, **{k: v.numpy() for k, v in net.state_dict().items()})
    back = flatten(convert_mixconvnext(str(npz)))
    want = flatten(params)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(back[k]), want[k], err_msg=k)
        assert np.asarray(back[k]).shape == want[k].shape, k


def test_init_params_is_seeded_and_shaped_like_the_jax_tree(params):
    from dsgan_tpu.models import init_params as jax_init_params

    g = jax_define_G(3, 3, 32, "MixConvNeXtML", dtype=None, inference=True)
    shapes = jax.eval_shape(lambda: jax_init_params(g, jax.random.PRNGKey(0), (1, 32, 32, 3)))
    jshapes = {k: v.shape for k, v in flatten(shapes["params"]).items()}
    flat = flatten(params)
    assert {k: v.shape for k, v in flat.items()} == jshapes
    assert sum(v.size for v in flat.values()) == 22_425_232
    again = flatten(init_params(SEED))
    assert all(np.array_equal(flat[k], again[k]) for k in flat)
    assert flat["c2/pwconv1/bias"].max() == 0.0
    assert float(flat["local/mid32/attn/relu1/negative_slope"]) == 0.25
    assert abs(float(flat["c5/pwconv1/kernel"].std()) - 0.02) < 1e-3


def test_npz_params_load_into_the_port(params, tmp_path):
    npz = tmp_path / "g_jax.npz"
    save_params_npz(params, str(npz))
    loaded = flatten(load_params_npz(str(npz)))
    assert all(np.array_equal(loaded[k], v) for k, v in flatten(params).items())
    sd = state_dict_from_jax(load_params_npz(str(npz)))
    net = define_G(3, 3, 32, "MixConvNeXtML", dtype=torch.float32, device="cpu", params=params)
    assert all(torch.equal(sd[k], v) for k, v in net.state_dict().items())


def test_generator_matches_jax(params, jax_forward):
    x = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax_forward(jnp.asarray(x)))
    net = define_G(3, 3, 32, "MixConvNeXtML", dtype=torch.float32, device="cpu",
                   gelu_mode="exact", params=params)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)


def test_other_generators_are_not_ported():
    """Every recipe of the JAX package's define_G is ported; a name it does
    not know is refused."""
    with pytest.raises(NotImplementedError, match="not recognized"):
        define_G(3, 3, 64, "resnet_12blocks", device="cpu")
