"""peak_mem_gib.sample: the allocator's peak over the window and the traced
slice, in GiB (`torch.cuda.max_memory_allocated` after a reset at the end
of set-up)."""

from benchmark.lib.readers import peak_gib


def read(rec):
    return peak_gib(rec)
