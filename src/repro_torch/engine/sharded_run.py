"""Device loss during serving.

The port serves on one device for now (multi-GPU serving is later work):
this module holds only :class:`DeviceLossError`, the error a watchdog or
a chaos hook raises at a dispatch boundary.  With no mesh to shrink onto,
:class:`~repro_torch.engine.stream_server.StreamServer` treats it as fatal
and lets it propagate, as the reference does for a single device.
"""

from __future__ import annotations


class DeviceLossError(RuntimeError):
    """Devices dropped out mid-serving.  Raised by hardware watchdogs in
    production and by chaos hooks in the soak harness
    (:mod:`repro_torch.engine.chaos`)."""

    def __init__(self, n_lost: int = 1, detail: str = ""):
        self.n_lost = int(n_lost)
        msg = f"lost {self.n_lost} device(s) mid-serving"
        super().__init__(msg + (f": {detail}" if detail else ""))
