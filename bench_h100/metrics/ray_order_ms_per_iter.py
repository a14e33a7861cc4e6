"""Device milliseconds per loop iteration of the ray ordering before the
traversal: the radix sort of the rays (`sort_rays`) and the packet order
(accel/cluster.py, ops/ray_sort.py, csrc/ray_sort.cu)."""

UNIT = "ms"
LAYER = "intersect"
MOVES = {"batch": "msamples_per_s", "orbit": "preview_ms_p95"}
KERNELS = ("sort_cluster_kernel", "sort_keys_kernel", "sort_pass_kernel", "packet_order_kernel")


def read(ctx):
    seconds = ctx.seconds_of(ctx.device, KERNELS)
    return seconds / ctx.iters * 1e3 if seconds > 0 and ctx.iters else None
