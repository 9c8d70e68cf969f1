"""Device ms of the embedding gathers' backward (``indexing_backward_kernel``)
per optimizer step of the traced stretch."""


def read(trace, shape):
    ms, calls = trace.kernel_ms(lambda n: "indexing_backward_kernel" in n)
    return {"value": ms / trace.units} if calls else None
