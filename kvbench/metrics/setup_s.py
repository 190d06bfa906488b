"""setup_s (s): from the process's start to the window's start: imports,
the kernels' build or load, the weights, the program's set-up, the
warm-up of the cell's shapes (and a serving cell's arrivals before the
window)."""


def read(rec):
    return rec.setup_s
