"""Device milliseconds of the traversal kernels per loop iteration: the
cluster accel's closest-hit and any-hit traversals with their
packet-weight pre-pass (ops/intersect_cluster.py, csrc/cluster_*.cu), and
brute force where a scene has no accel (csrc/brute.cu)."""

UNIT = "ms"
LAYER = "kernels"
MOVES = {"batch": "msamples_per_s", "orbit": "preview_ms_p95"}
KERNELS = ("streamed_kernel", "packet_weight_kernel", "brute_kernel")


def read(ctx):
    seconds = ctx.seconds_of(ctx.device, KERNELS)
    return seconds / ctx.iters * 1e3 if seconds > 0 and ctx.iters else None
