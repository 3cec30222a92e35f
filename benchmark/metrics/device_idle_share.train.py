"""The share of a traced stretch of training steps in which no operation ran on
the card (torch.profiler).

Layer: device. Moves: ``train_img_per_s``. Unit: %."""

from benchmark import roofline

LAYER = "device"
MOVES = "train_img_per_s"
UNIT = "%"


def read(run):
    return roofline.idle_percent(run) if run["kind"] == "train" else None
