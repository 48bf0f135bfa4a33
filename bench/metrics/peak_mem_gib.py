"""The allocator's peak on the card (``max_memory_allocated``) before the
reference runs, in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
