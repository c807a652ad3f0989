"""Synchronising CUDA calls a planning call (the program's `host_syncs`
counter, PyTorch's sync debug mode inside `graspnerf.plan`), profiled
segment."""
from bench_port import program_spans


def read(rec):
    return program_spans.counter_per_call("host_syncs")
