"""The yardstick's arithmetic: the card's peaks, the work of one block-core
call forward and backward, and the model FLOPs of a step counted over the
plain reference.

Peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W limit:
3.35 TB/s of HBM, 989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s
float32 outside them.

A block-core call (``out = gelu(IN(h) @ W1 + b1) @ W2 + b2 + x @ Ws`` on
B * HW pixel rows of C channels, P outputs) needs, forward, the GEMMs
2 * B * HW * (4C^2 + 4CP + CP) FLOPs and, backward, those of its own
cotangents and weight gradients: dG = dOut @ W2^T, dW2, dWs, dx, dA = dH @
W1^T, dW1, 2 * B * HW * (8C^2 + 10CP). A kernel that recomputes the hidden
in its backward does 8 * B * HW * C^2 more; that is its choice and is not
counted. Bytes: each input read once and each output written once.
"""

import contextlib

import torch

HBM_BPS = 3.35e12
PEAK = {"bfloat16": 989e12, "float32": 67e12}
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def fwd_work(b, hw, c, p, dtype):
    """(FLOPs, bytes) of one forward call: h and x read, the output
    written, the weights read, the (B, C) statistics read."""
    s = ITEMSIZE[dtype]
    weights = 4 * c * c + 4 * c * p + c * p + 4 * c + p
    nbytes = b * hw * (2 * c + p) * s + weights * s + 2 * b * c * 4
    return 2 * b * hw * (4 * c * c + 5 * c * p), nbytes


def bwd_work(b, hw, c, p, dtype):
    """(FLOPs, bytes) of one backward call: h, x and the output cotangent
    read, the cotangents of the normalized input and of x written, the
    weights read and their f32 gradients written, the statistics read and
    the two per-(image, channel) sums written."""
    s = ITEMSIZE[dtype]
    weights = 4 * c * c + 4 * c * p + c * p + 4 * c
    grads = 4 * (weights + p)
    nbytes = (b * hw * (2 * c + p) * s + b * hw * 2 * c * s + weights * s + grads
              + 4 * b * c * 4)
    return 2 * b * hw * (8 * c * c + 10 * c * p), nbytes


def bound_s(flops, nbytes, dtype):
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK[dtype], nbytes / HBM_BPS)


def sites_bound_s(sites, direction, dtype):
    """Summed least time of the block-core calls ``sites`` ((B, HW, C, P)
    each), forward or backward."""
    work = fwd_work if direction == "fwd" else bwd_work
    return sum(bound_s(*work(b, hw, c, p, dtype), dtype) for b, hw, c, p in sites)


@contextlib.contextmanager
def block_sites(net_cls, sites):
    """Record (B, HW, C, P) of every forward of a ``net_cls`` module
    (the reference's ConvNeXt block) into ``sites`` while the context is
    open."""

    def hook(module, args, out):
        x = args[0]
        sites.append((x.shape[0], x.shape[2] * x.shape[3], x.shape[1], out.shape[1]))

    handle = torch.nn.modules.module.register_module_forward_hook(
        lambda m, a, o: hook(m, a, o) if isinstance(m, net_cls) else None)
    try:
        yield sites
    finally:
        handle.remove()


def count_step(fn):
    """(FLOPs, block-core sites) of ``fn()``, which runs the reference on
    the meta device: FlopCounterMode's count of its matrix products and
    convolutions, forward and backward, and every ConvNeXt block call."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.nets import Block

    sites = []
    with block_sites(Block, sites), FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops(), sites


def mfu_percent(run):
    """The whole step's (or request's) model FLOPs over the window, as a
    share of the card's peak in the configuration's dtype."""
    if run["window_s"] <= 0 or run["info"]["platform"] != "gpu":
        return None
    return 100.0 * run["flops_per_unit"] * run["units"] / run["window_s"] / PEAK[run["dtype"]]


def kernel_roofline_percent(run, kernels, direction):
    """The least time of the traced stretch's block-core calls (its units
    times the unit's calls ``<direction>_sites``) over the device time of
    the kernels whose names hold any of ``kernels``; None where the trace
    has none of them."""
    trace = run["trace"]
    if trace is None:
        return None
    seconds = trace.seconds_of(kernels)
    if seconds <= 0:
        return None
    sites = run["fwd_sites"] if direction == "fwd" else run["bwd_sites"]
    bound = run["traced_units"] * sites_bound_s(sites, direction, run["dtype"])
    return 100.0 * bound / seconds


def idle_percent(run):
    """The share of the traced stretch in which no device operation ran."""
    trace = run["trace"]
    if trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def host_ms_per_unit(run):
    """Mean host milliseconds per step (or request) in the calls into the
    program during the window."""
    if not run["dispatch_s"]:
        return None
    return 1e3 * sum(run["dispatch_s"]) / (len(run["dispatch_s"]) * run["dispatch_units"])
