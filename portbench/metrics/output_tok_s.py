"""Output tokens per second: every token the window produced over the
window's seconds (host clock, first step's start to last step's end)."""


def read(rec):
    return rec["tokens"] / rec["window_s"] if rec["window_s"] > 0 else None
