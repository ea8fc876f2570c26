"""The int8 init of a level >= 1 (`csrc/sparse_init.cu`: `cell_kernel` and
`score_kernel`, one launch each per batch): the level below's events and
scales read, the raw bank's two int8 digit planes read, the score buffer
``[B, Ka, npos]``, e0 and the peak written once; per nonzero map cell and
raw atom, W x 4 map digits x 2 bank planes, a multiply and an add."""

KERNELS = ("cell_kernel", "score_kernel")


def work(launch: dict) -> tuple[float, float]:
    b, m, n_raw, w, c, k, npos = (
        launch[key] for key in ("blocks", "events", "n_raw", "width", "channels", "atoms", "npos")
    )
    nbytes = 4 * (3 * m + 2 * b) + n_raw * w * c * 2 + 4 * (b * k * npos + 2 * b)
    return float(m * n_raw * w * 16), float(nbytes)
