"""Mean time to first dispatch in ms of the window's requests: the
server's lifetime ``ttfd_hist`` (exact sum and count) differenced over the
window."""


def read(run):
    (t0, n0), (t1, n1) = run.cell.before["ttfd"], run.cell.after["ttfd"]
    return 1e3 * (t1 - t0) / (n1 - n0) if n1 > n0 else None
