"""Device ms of an explain's mask decoder (`explain.decoder`: the UNet on
the cropped magnitude and the mask's pad to the spectrogram), by CUDA events
at the program's span edges, over the traced explains."""

from portbench.spans import device_ms_per_unit


def read(r):
    return device_ms_per_unit(r, "explain.decoder")
