"""Set-up: process start to the first timed call (imports, the CUDA
context, the kernels' libraries, weights and inputs, warm-up and
capture; a first run in a checkout also builds the kernels)."""


def read(run):
    return run.setup_s
