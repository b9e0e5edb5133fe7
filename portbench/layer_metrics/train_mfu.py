"""The whole training step's share, in %, of the card's peak over the
untraced window (host clock): the least time of its operations at the peak
rate of their types (`costs/model.py::train_step_ops`), times the steps
completed, over the window's seconds."""

from portbench.costs.model import least_seconds, train_step_ops


def read(r):
    w = r.window
    if not w.get("units") or w.get("seconds", 0) <= 0:
        return None
    return 100.0 * least_seconds(train_step_ops(r.cfg, w["batch"])) * w["units"] / w["seconds"]
