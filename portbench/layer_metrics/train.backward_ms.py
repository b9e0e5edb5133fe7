"""Device ms of a training step's backward phase (`train.backward`: the
gradients' zeroing, the backward pass through the embedder, iSTFT, STFT
and the UNet, their data-axis mean), by CUDA events at the program's span
edges, over the traced steps."""

from portbench.spans import device_ms_per_unit


def read(r):
    return device_ms_per_unit(r, "train.backward")
