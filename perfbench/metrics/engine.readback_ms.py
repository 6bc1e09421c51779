"""Mean ms an engine call spends bringing the layer outputs to the host,
where the host waits for the card: the program's ``engine.readback`` span."""

from perfbench.spans import stage_ms


def read(run):
    return stage_ms("engine.readback")
