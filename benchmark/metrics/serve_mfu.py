"""A request's model FLOPs (the generator forward, counted over the plain
reference) times the window's requests, over the window, as a share of the
card's peak.

Layer: whole step. Moves: ``serve_img_per_s``. Unit: %."""

from benchmark import roofline

LAYER = "whole step"
MOVES = "serve_img_per_s"
UNIT = "%"


def read(run):
    return roofline.mfu_percent(run) if run["kind"] == "serve" else None
