"""Device ms of the embedder's convolutional frontend (`embed.frontend`:
the seven convs) in an explain, by CUDA events at the program's span edges,
over the traced explains."""

from portbench.spans import device_ms_per_unit


def read(r):
    return device_ms_per_unit(r, "embed.frontend")
