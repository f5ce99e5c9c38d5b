"""peak_mem_gib: the allocator's peak over the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``)
above the bytes allocated when the window opened (the benchmark's input
and its kept outputs), in GiB.  None where nothing was allocated (a run
on the CPU)."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30 if rec["peak_bytes"] > 0 else None
