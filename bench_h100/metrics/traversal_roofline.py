"""The traversal kernels' share of their roofline, in percent: the least
bytes their work needs (roofline.traversal_bytes: each traced ray's
origin and direction read once, its hit written once, the scene's
vertices read once a launch) over the card's published HBM bandwidth,
divided by the kernels' device time.  A bound by bytes: the same inputs
give the same count whatever implements them."""

UNIT = "%"
LAYER = "kernels"
MOVES = {"batch": "msamples_per_s", "orbit": "preview_ms_p95"}
KERNELS = ("streamed_kernel", "packet_weight_kernel", "brute_kernel")


def read(ctx):
    seconds = ctx.seconds_of(ctx.device, KERNELS)
    peak = ctx.peaks.get("hbm_bytes_per_s")
    if not seconds or not peak or not ctx.traversal_bytes:
        return None
    return ctx.traversal_bytes / peak / seconds * 100.0
