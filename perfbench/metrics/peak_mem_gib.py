"""peak_mem_gib: torch.cuda.max_memory_allocated over set-up and window,
read when the window closes, in GiB; on several cards the fullest one's."""

COMBINE = "max"


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30 if ctx["peak_bytes"] else None
