"""Kernel F's (the grouped positional conv's forward) share of its roofline
over the traced explains (device trace): the least time of its work at the
cell's shapes, an explain embedding 3 x batch clips, over the device time
of its forward launches. None where the program has no such kernel."""

import re

from portbench.costs.kernels import DTYPE_BYTES, embedder_frames
from portbench.costs.peaks import bound_s

FORWARD = re.compile(r"pos_conv_fwd_kernel")


def least_seconds(cfg: dict, batch: int) -> float:
    """Kernel F's least time in one explain: 2 T H (H / groups) k operations
    a clip over 3 x batch clips; x and y read and written once, the weights
    read once a launch."""
    e = cfg["embedder"]
    n = int(cfg["audio"]["clip_seconds"] * cfg["audio"]["sample_rate"])
    t, h = embedder_frames(e, n), e["hidden_size"]
    k, groups = e["num_conv_pos_embeddings"], e["num_conv_pos_embedding_groups"]
    clips, size = 3 * batch, DTYPE_BYTES[e["dtype"]]
    ops = 2.0 * clips * t * h * (h // groups) * k
    nbytes = size * (2.0 * clips * t * h + h * (h // groups) * k)
    return bound_s(nbytes, {e["dtype"]: ops})[0]


def read(r):
    if r.trace is None:
        return None
    device_s, launches = r.trace.kernel_seconds(FORWARD)
    if launches == 0 or device_s <= 0:
        return None
    return 100.0 * r.trace.units * least_seconds(r.cfg, r.window["batch"]) / device_s
