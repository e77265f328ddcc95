"""setup_s: from the process's start to the window's: imports, the CUDA
context, the kernels' build (or their load from the checkout's cache), the
weights, the scene, the nets and the warm-up (a training cell's first
steps, a serving cell's first tile)."""


def read(run):
    return run.setup_s
