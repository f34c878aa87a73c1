"""Modelled bridge milliseconds per step: ``GatewayStats.bridge_time_s``
over the window, over its steps.  The virtual clock's bridge law (the
mix's profile, CC on), not a device time."""


def read(rec):
    n = len(rec["steps"])
    return rec["gateway"]["bridge_s"] / n * 1e3 if n else None
