"""``ssd_scan_roofline``: the least time of the traced prefills' scans over
the device time of the ``ssd_scan`` kernel's four phases
(``csrc/ssd_scan.cu``) in the profiler's trace, in %.  The least time of
one scan is the larger of its operations over the bf16 peak and its bytes
(inputs read once, output and final state written once, bf16 operands)
over the HBM bandwidth (``gpubench/counts/ssd_scan.py``); one scan a
layer a prefill."""
from gpubench.counts import mamba_prefill, ssd_scan
from gpubench.lib.trace import kernel_seconds

KERNELS = ("ssd_prep", "ssd_states", "ssd_carry", "ssd_outputs")


def read(ctx):
    peaks, reading = ctx.get("peaks"), ctx.get("trace")
    if not peaks or not reading:
        return None
    n, seconds = kernel_seconds(reading, KERNELS)
    if not n or seconds <= 0:
        return None
    cfg, p = ctx["cfg"], ctx["params"]
    m = mamba_prefill.dims(cfg)
    b, l = p["batch"], p["seq"]
    q = min(cfg["ssm_chunk"], l)
    one = max(ssd_scan.flops(b, l, m["h"], m["p"], m["n"], q)
              / peaks["bf16_flops"],
              ssd_scan.bytes_moved(b, l, m["h"], m["p"], m["n"])
              / peaks["hbm_bytes"])
    scans = cfg["n_layers"] * ctx["trace_calls"]
    return 100.0 * one * scans / seconds
