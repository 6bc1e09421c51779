"""Median latency in ms of every request due in the window, from its due
time to the client's collection of its result; a rejected request counts
as the window's length, beyond every limit."""

from perfbench.stats import percentile_ms


def read(run):
    return percentile_ms(run.cell.latency, 50)
