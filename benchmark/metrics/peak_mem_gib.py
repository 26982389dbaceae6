"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` over the whole
run up to the window's close, set-up included, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30
