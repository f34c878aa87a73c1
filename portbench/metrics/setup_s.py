"""Set-up seconds: process start to the window's start (imports, the
weights made on the device, the engine, the kernels' first use, the
warm-up request and every client's first admission)."""


def read(rec):
    return rec["setup_s"]
