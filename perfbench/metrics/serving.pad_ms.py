"""Mean ms a front-end engine call spends zero-padding its requests into
the bucket: the program's ``serving.pad`` span over its ``serving.execute``
spans."""

from perfbench.spans import stage_ms


def read(run):
    return stage_ms("serving.pad", per="serving.execute")
