"""Device ms of an explain's int8 quantize and rescale passes
(`int8.quantize` + `int8.rescale`: the activations' scales and codes, the
int32 sums back to f32), by CUDA events at the program's span edges, over
the traced explains."""

from portbench.spans import device_ms_per_unit


def read(r):
    return device_ms_per_unit(r, "int8.quantize", "int8.rescale")
