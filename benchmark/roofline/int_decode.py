"""The integer decode (`csrc/int_decode.cu` over `decode_tiles.cuh`,
`decode_tiles_kernel`), one launch over a chunk: each event's position,
atom and code and each block's two scalars read, the integer
representation table ``[K, W]`` read, the rows ``[B, N]`` written once; per
event W multiply-adds."""

KERNELS = ("decode_tiles_kernel",)


def work(launch: dict) -> tuple[float, float]:
    b, ev, w, k, n = (launch[key] for key in ("blocks", "events", "width", "atoms", "n"))
    nbytes = 12 * ev + 8 * b + 4 * (k * w + b * n)
    return float(2 * ev * w), float(nbytes)
