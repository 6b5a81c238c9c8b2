"""The port's Hopper kernels (CUDA C++ in ``csrc/`` and Triton), each beside
its plain PyTorch version and a launch counter."""


class Launches:
    """A launch counter of a kernel mode that is not a wrapper's own (the
    wrapper counts every launch; a mode's counter counts its share)."""

    launches = 0
