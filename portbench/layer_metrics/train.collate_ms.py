"""Device ms of a training step's collate phase (the STFT and the target's
embed, without gradient), by CUDA events at the step's own marks, averaged
over the traced steps."""


def read(r):
    return r.window.get("collate_ms")
