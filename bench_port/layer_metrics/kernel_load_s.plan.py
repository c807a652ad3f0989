"""Seconds the run spent in `build.load` (each kernel library built or
found, and loaded; the program's `kernel_load_s` counter), set-up."""
from bench_port import program_spans


def read(rec):
    return program_spans.counter("kernel_load_s")
