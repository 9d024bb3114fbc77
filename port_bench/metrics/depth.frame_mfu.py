"""Model step: a frame's model FLOPs over its span on the device (the CUDA
events from the frame's start to the evaluator's mark "render", the mean
over the window's frames) and 989 TFLOP/s (bf16), in %. The stream sends
frames at a fixed rate, so FLOPs over the window's seconds would read
the rate, not the model step."""
from port_bench import flops


def read(run):
    spans = [s["encode"] + s["render"] for s in run.stages
             if "encode" in s and "render" in s]
    if not spans:
        return None
    ms = sum(spans) / len(spans)
    return 100.0 * run.work_flops / (ms / 1e3) / flops.BF16_FLOP_S
