"""Kernel libraries compiled in the run (the program's `kernels_built`
counter, `build.build`): 0 where the checkout's build cache is warm."""
from bench_port import program_spans


def read(rec):
    return program_spans.counter("kernels_built")
