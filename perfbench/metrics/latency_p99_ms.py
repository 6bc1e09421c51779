"""99th-percentile latency in ms of every request due in the window (see
``latency_p50_ms``)."""

from perfbench.stats import percentile_ms


def read(run):
    return percentile_ms(run.cell.latency, 99)
