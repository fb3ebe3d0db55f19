"""setup_s: from the process's start to the end of the warm-up: imports,
CUDA start-up, data made from the seed, train, add, any kernel build, and
the warm-up batches."""


def read(run):
    return run.setup_s
