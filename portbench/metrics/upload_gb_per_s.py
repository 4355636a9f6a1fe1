"""Weight bytes over the seconds of the endpoints' ``upload()`` calls
that started in the window, in GB/s (1e9 bytes)."""


def read(run):
    ups = [u for u in run.uploads if 0 <= u[0] < run.seconds]
    secs = sum(u[1] for u in ups)
    return sum(u[2] for u in ups) / secs / 1e9 if secs > 0 else None
