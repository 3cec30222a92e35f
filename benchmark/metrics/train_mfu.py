"""The training step's model FLOPs (forward and backward, counted over the
plain reference, no recompute) times the steps of the window, over the
window, as a share of the card's peak.

Layer: whole step. Moves: ``train_img_per_s``. Unit: %."""

from benchmark import roofline

LAYER = "whole step"
MOVES = "train_img_per_s"
UNIT = "%"


def read(run):
    return roofline.mfu_percent(run) if run["kind"] == "train" else None
