"""The most device memory the program held at once during the window:
``torch.cuda.max_memory_allocated()``, reset after the warm-up, in MiB.
None where the run had no CUDA device."""


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / 2**20
