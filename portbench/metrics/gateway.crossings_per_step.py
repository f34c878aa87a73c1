"""Host<->device crossings through the ``TransferGateway`` per step
(``GatewayStats`` h2d + d2h over the window, over its steps)."""


def read(rec):
    n = len(rec["steps"])
    return rec["gateway"]["crossings"] / n if n else None
