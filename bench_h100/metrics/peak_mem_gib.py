"""The allocator's peak over the window, in GiB
(`torch.cuda.max_memory_allocated()` after its peak was reset before the
window)."""

UNIT = "GiB"
LAYER = "device"
MOVES = {"batch": "msamples_per_s", "orbit": "preview_ms_p95"}
KERNELS = ()


def read(ctx):
    return ctx.peak_mem_bytes / 2**30 if ctx.peak_mem_bytes else None
