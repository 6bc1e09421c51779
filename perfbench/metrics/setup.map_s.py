"""Host seconds of the program's ``map_model`` (quantization, the ILP
mapping and the control memories), timed around the call in set-up."""


def read(run):
    return run.cell.system["map_s"]
