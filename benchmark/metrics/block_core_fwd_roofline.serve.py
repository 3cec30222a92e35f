"""K1/K3 in serving: the least time of the traced requests' block-core forward
calls over the kernels' device time.

Layer: block-core kernels. Moves: ``serve_img_per_s``. Unit: %."""

from benchmark import roofline

LAYER = "block-core kernels"
MOVES = "serve_img_per_s"
UNIT = "%"

# the kernels of K1 and K3 (csrc/block_core2_fwd_sm90.cu): the fused wgmma
# route, the two-pass route, the narrow route
KERNELS = ("bc2_fwd_sm90", "bc_fwd_out_sm90", "bc_fwd_narrow")


def read(run):
    if run["kind"] != "serve":
        return None
    return roofline.kernel_roofline_percent(run, KERNELS, "fwd")
