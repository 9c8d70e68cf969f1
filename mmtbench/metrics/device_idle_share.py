"""The share of the traced stretch's wall time in which no operation ran on
the card (1 - the union of the device records / the wall), in %."""


def read(trace, shape):
    if not trace.device:
        return None
    return {"value": 100.0 * (1.0 - trace.busy_s() / trace.wall_s)}
