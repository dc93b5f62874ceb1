"""The share of the traced window in which no kernel, copy or fill ran
on the card.  Source: the profiler's CUDA activity."""

from bench_cuda.trace import idle_pct


def read(rec):
    return idle_pct(rec.get("trace"))
