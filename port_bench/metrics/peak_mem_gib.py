"""The caching allocator's peak over the window (``peak_mem_gib.gen``,
``peak_mem_gib.train``): ``torch.cuda.max_memory_allocated`` after a reset
at the window's start, GiB."""


def read(rec):
    if rec["peak_window_bytes"] is None:
        return None
    return rec["peak_window_bytes"] / 2 ** 30
