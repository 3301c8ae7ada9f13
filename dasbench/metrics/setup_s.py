"""Seconds from the process's start to the measured window. DSSoC cells:
imports, CUDA's start, the inputs' task graphs, the chunk size (the
autotune's probe on a checkout's first run, its cache after), and one
warm-up sweep of each scheduler mode of the traffic at the cell's shapes
(the kernels' build on a checkout's first run). LM cells: imports,
CUDA's start, the weights drawn on the device, and at each prompt length
a warm-up prefill call and a few decode steps over the batch's caches."""


def read(r):
    return r.setup_s
