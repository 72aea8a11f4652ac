"""setup_s: from the start of the run to the start of the window: imports,
the CUDA context, the kernel library (built on a checkout's first run),
the inputs, plans and the cell's warm-up."""


def read(rec):
    return rec.setup_s
