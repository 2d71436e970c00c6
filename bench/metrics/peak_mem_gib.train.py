"""The device memory peak of the training window (after a reset at its
start), in GiB."""


def read(r):
    if r.cell["driver"] != "train" or "window_peak_bytes" not in r.counters:
        return None
    return r.counters["window_peak_bytes"] / 2 ** 30
