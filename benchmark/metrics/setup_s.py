"""Set-up: from the start of the process to the start of the window
(imports, the card's context, the pool of calls, the kernels' build and
load, the cell's shapes warmed up)."""


def read(run):
    return run.setup_s
