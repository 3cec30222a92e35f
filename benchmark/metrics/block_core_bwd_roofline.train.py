"""K2/K4 (the block-core backward kernels: prep, hidden, dn, weights, reduce,
narrow) in training: the least time of the traced steps' block-core backward
calls (``roofline.bwd_work``: the backward's own GEMMs, not the recomputed
hidden) over the kernels' device time.

Layer: block-core kernels. Moves: ``train_img_per_s``. Unit: %."""

from benchmark import roofline

LAYER = "block-core kernels"
MOVES = "train_img_per_s"
UNIT = "%"

# every kernel of K2 and K4 (csrc/block_core2_bwd_sm90.cu)
KERNELS = ("bc2_bwd_sm90",)


def read(run):
    if run["kind"] != "train":
        return None
    return roofline.kernel_roofline_percent(run, KERNELS, "bwd")
