"""Seeded initialization with numpy (torch's RNG is never used).

The reference's init pass (networks.py:49-79 ``init_net``, gain 0.02) as
the JAX package applies it to its parameter tree (``registry.reinit_params``
and ``ops/initializers.py``): every ``kernel`` leaf redrawn from
``--init_type`` (normal: N(0, gain); xavier: N(0, gain * sqrt(2 / (fan_in
+ fan_out))); kaiming: N(0, sqrt(2 / fan_in)); orthogonal: gain times the
Q of a QR, signs fixed by R's diagonal), every ``bias`` 0, every BatchNorm
``scale`` N(1, gain), the cascade LayerNorm's ``gamma`` 1 and ``beta`` 0,
and the PReLU ``negative_slope`` its construction value 0.25. Fans are
those of the JAX (HWIO, or (in, out)) shape, which equal torch's. Leaves
are drawn in sorted path order from one ``np.random.default_rng(seed)``,
so one seed always gives one tree.
"""

import numpy as np

INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")


def _fans(shape):
    receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def draw_kernel(rng, shape, init_type="normal", gain=0.02):
    """One kernel of JAX shape ``shape`` (f32)."""
    if init_type == "normal":
        w = gain * rng.standard_normal(shape)
    elif init_type == "xavier":
        fan_in, fan_out = _fans(shape)
        w = gain * (2.0 / (fan_in + fan_out)) ** 0.5 * rng.standard_normal(shape)
    elif init_type == "kaiming":
        # torch kaiming_normal_(a=0, mode='fan_in')
        w = (2.0 / _fans(shape)[0]) ** 0.5 * rng.standard_normal(shape)
    elif init_type == "orthogonal":
        flat = (int(np.prod(shape[:-1])), shape[-1])
        a = rng.standard_normal((max(flat), min(flat)))
        q, r = np.linalg.qr(a)
        q = q * np.sign(np.diag(r))
        w = gain * (q.T if flat[0] < flat[1] else q).reshape(shape)
    else:
        raise NotImplementedError(f"initialization method [{init_type}] is not implemented")
    return np.asarray(w, np.float32)


def init_tree(shapes, seed, init_type="normal", gain=0.02):
    """``shapes``: {slash-joined JAX path: shape} -> {path: f32 ndarray}."""
    if init_type not in INIT_TYPES:
        raise NotImplementedError(f"initialization method [{init_type}] is not implemented")
    rng = np.random.default_rng(seed)
    out = {}
    for path in sorted(shapes):
        shape = tuple(shapes[path])
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel":
            out[path] = draw_kernel(rng, shape, init_type, gain)
        elif leaf == "negative_slope":
            out[path] = np.full(shape, 0.25, np.float32)
        elif leaf in ("bias", "beta"):
            out[path] = np.zeros(shape, np.float32)
        elif leaf == "gamma":
            out[path] = np.ones(shape, np.float32)
        elif leaf == "scale":
            out[path] = (1.0 + gain * rng.standard_normal(shape)).astype(np.float32)
        else:
            raise ValueError(f"no init rule for parameter {path!r}")
    return out
