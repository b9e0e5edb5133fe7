"""Device ms of an explain's embed (`explain.embed`: the concatenation of
the clean and both masked clips and the 3B-batch embedder pass), by CUDA
events at the program's span edges, over the traced explains."""

from portbench.spans import device_ms_per_unit


def read(r):
    return device_ms_per_unit(r, "explain.embed")
