"""Per-layer metric peak_mem_gib: the most device memory the allocator
held during the window (``torch.cuda.max_memory_allocated`` after a
reset at the window's start), in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
