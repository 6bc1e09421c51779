"""Requests completed in the window over the window's seconds (host
clock): every call of the closed loop that started in the window, with all
its requests, over the time to the last one's end."""


def read(run):
    return run.cell.attempted / run.cell.window_s
