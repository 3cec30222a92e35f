"""Host milliseconds from the call to the serving function to its return,
before the copy-out waits for the device; mean over the window's requests.

Layer: serving shell. Moves: ``serve_p95_ms``. Unit: ms."""

from benchmark import roofline

LAYER = "serving shell"
MOVES = "serve_p95_ms"
UNIT = "ms"


def read(run):
    return roofline.host_ms_per_unit(run) if run["kind"] == "serve" else None
