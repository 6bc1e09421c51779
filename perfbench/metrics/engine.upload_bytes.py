"""Mean bytes an engine call puts on the card as its input: the program's
``batched_run.upload_counts`` (bytes of input masks uploaded, and how
many uploads carried them; one a call off a mesh), over the process's
life.  Set-up's warm-up calls serve the window's bucket shapes.  A program
without the counter reads ``None``."""


def read(run):
    from repro_torch.engine import batched_run
    counts = getattr(batched_run, "upload_counts", None)
    if not counts or not counts["uploads"]:
        return None
    return counts["bytes"] / counts["uploads"]
