"""The share of a device-only trace's window (first device activity to
last, over a few units of work after the measured window) in which no
kernel or copy ran, in percent."""


def read(r):
    busy = r.get("device_busy")
    if not busy or busy[2] <= 0:
        return None
    return (1 - busy[1] / busy[2]) * 100
