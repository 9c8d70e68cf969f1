"""Device ms of the cuBLAS products (projections, FFN, heads) per step or
batch of the traced stretch."""

CUBLAS_TAGS = ("gemm", "xmma", "cutlass", "nvjet", "sm90")


def read(trace, shape):
    ms, calls = trace.kernel_ms(lambda n: any(t in n.lower() for t in CUBLAS_TAGS)
                                and "rel_attention" not in n)
    return {"value": ms / trace.units} if calls else None
