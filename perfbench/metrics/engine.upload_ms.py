"""Mean ms an engine call spends putting its input raster on the card
(``from_numpy`` and the pageable copy): the program's ``engine.upload``
span."""

from perfbench.spans import stage_ms


def read(run):
    return stage_ms("engine.upload")
