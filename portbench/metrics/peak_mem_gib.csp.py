"""Device memory peak over the window (torch.cuda.max_memory_allocated), GiB."""

from portbench.lib.readers import peak_gib


def read(ctx):
    return peak_gib(ctx)
