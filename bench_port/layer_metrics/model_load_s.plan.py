"""Seconds the run spent in `models.load_graspnerf` (the model built,
its weights loaded, moved to the card; the program's `model_load_s`
counter), set-up."""
from bench_port import program_spans


def read(rec):
    return program_spans.counter("model_load_s")
