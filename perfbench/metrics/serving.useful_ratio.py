"""Real request steps over padded ``b_pad * t_pad`` cells of the window's
engine calls (the program's ``telemetry`` records)."""


def read(run):
    cell = run.cell
    cells = sum(r["b_pad"] * r["t_pad"] for r in cell.telemetry)
    steps = sum(cell.lengths[i] for g, _ in cell.served
                for i in cell.groups[g])
    return steps / cells if cells else None
