"""``mfu.<cell kind>``: the operations the window's work needs over the
card's bf16 peak times the window, in %.  The driver counts them with the
count module the configuration names for the cell's kind (``counts`` in
``gpubench/configs/<config>.json``): for training the frozen matmuls
forward and for the activations' gradients, attention or the chunked
scan, and the LoRA factors, no recompute; for a prefill the forward
pass."""


def read(ctx):
    peaks = ctx.get("peaks")
    if not peaks or ctx.get("window_s", 0) <= 0:
        return None
    return 100.0 * ctx["flops"] / (peaks["bf16_flops"] * ctx["window_s"])
