"""The share of a traced stretch of requests in which no operation ran on the
card (torch.profiler).

Layer: device. Moves: ``serve_img_per_s``. Unit: %."""

from benchmark import roofline

LAYER = "device"
MOVES = "serve_img_per_s"
UNIT = "%"


def read(run):
    return roofline.idle_percent(run) if run["kind"] == "serve" else None
