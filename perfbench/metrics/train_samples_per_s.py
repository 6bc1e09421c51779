"""Samples of every training step completed in the window over the
window's seconds (host clock; each step ends when the host holds its
loss, as the program's train loop reads it)."""


def read(run):
    return run.cell.attempted / run.cell.window_s
