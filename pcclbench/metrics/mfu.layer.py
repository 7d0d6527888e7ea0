"""The step's share of the chip's peak: the layer's model operations (the
down-projection, 2·tokens·K·N) done in the window, over the window's
seconds at 989 TFLOP/s (bf16), in %."""

from pcclbench.arith import PEAK_FLOPS


def read(r):
    f = r.work.get("model_flops")
    return 100.0 * f / (r.window_s * PEAK_FLOPS["bfloat16"]) if f else None
