"""The device time a call of every kernel the hand-written ones are not:
cuDNN's convolutions, cuBLAS, PyTorch's elementwise and reduction
kernels (the neck, head, loss, SimOTA, optimizer and glue), from the
profile."""


def read(run):
    p = run.window.profile
    if p is None or p.other_kernel_s <= 0:
        return None
    return 1e3 * p.other_kernel_s / p.calls
