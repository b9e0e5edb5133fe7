"""The whole explain's share, in %, of the card's peak over the untraced
window (host clock): the least time of its operations at the peak rate of
their types (`costs/model.py`), times the explains completed, over the
window's seconds."""

from portbench.costs.model import explain_ops, least_seconds


def read(r):
    w = r.window
    if not w.get("units") or w.get("seconds", 0) <= 0:
        return None
    return 100.0 * least_seconds(explain_ops(r.cfg, w["batch"])) * w["units"] / w["seconds"]
