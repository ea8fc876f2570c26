"""Block rows the traced calls added on the host into chunks summed per
level (`hsc_torch.runtime.ROWS_SUMMED_BY_LEVEL`'s growth), over the blocks
they restored (`clients/restore_levels.py`); None in a program without the
count."""


def read(run):
    return run.client.summed_rows_per_block()
