"""Calls of the encode's body on the card under cuDNN's algorithm search
(the program's `conv_search_calls` counter, counted always, the process's
total): 2 in a planning run, the warm-up's first eager call and the
capture after it; none where the program has no such counter."""
from bench_port import program_spans


def read(rec):
    t = program_spans.tracing()
    if t is None or "conv_search_calls" not in t.counters():
        return None
    return program_spans.counter("conv_search_calls")
