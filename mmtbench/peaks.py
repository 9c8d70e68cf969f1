"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the card's full 700 W): the bf16 tensor-core rate and the HBM3
bandwidth.  Shares are stated against these, with the card's power limit
beside them."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_ms(flops: float, nbytes: float):
    """(the least ms the card could take, "operations" or "bytes")."""
    f, b = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(f, b), "operations" if f >= b else "bytes"
