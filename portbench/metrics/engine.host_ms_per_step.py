"""Milliseconds a step spends in ``ServingEngine.step()`` outside the
model's calls (harness clock around ``step()`` less the model proxy's
host time inside it), over the window's steps outside the profiled
slice.  It holds the engine's own work and its wait at the drain."""


def read(rec):
    calls = rec.get("calls")
    steps = [s for s in rec["steps"] if not s["profiled"]]
    if calls is None or not steps:
        return None
    model_s = sum(c["host_s"] for c in calls if not c["profiled"])
    wall = sum(s["t1"] - s["t0"] for s in steps)
    return (wall - model_s) / len(steps) * 1e3
