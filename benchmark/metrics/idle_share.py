"""The device's idle share over the traced slice of calls or steps, in %:
100 x (1 - the union of the device ops' intervals / the slice's host
time). Nothing without device ops."""


def read(trace, ctx):
    return trace.idle_pct()
