"""The greedy loop (`csrc/mp_encode.cu`, `mp_encode_kernel`), one launch
over a batch: the init scores ``[B, K, npos]``, the quantizer steps and
energies, the Gram ``[K, K, 2W-1]`` and the weights read once, the events
written once; per event K x (2W-1) score updates of five float32
operations each (multiply, subtract, abs, weight, max)."""

KERNELS = ("mp_encode_kernel",)


def work(launch: dict) -> tuple[float, float]:
    """(operations, bytes) of one launch."""
    b, k, npos, lag, ev = (launch[key] for key in ("blocks", "atoms", "npos", "lag", "events"))
    nbytes = 4 * (b * k * npos + 3 * b + k * k * lag + k + 3 * ev + 2 * b)
    return float(ev * k * lag * 5), float(nbytes)
