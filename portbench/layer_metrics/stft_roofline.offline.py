"""Kernel B's (STFT) share of its roofline over the traced explains (device
trace): the least time of its work at the cell's shapes over its launches'
device time."""

from portbench.costs.kernels import roofline_percent


def read(r):
    return roofline_percent(r.trace, r.cfg, r.window["batch"], "stft")
