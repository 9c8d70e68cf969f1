"""Device ms of host-to-device copies per batch of the traced stretch."""


def read(trace, shape):
    ms, calls = trace.kernel_ms(lambda n: "HtoD" in n)
    return {"value": ms / trace.units} if calls else None
