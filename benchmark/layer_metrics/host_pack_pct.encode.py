"""Share of the encode calls' host wall time outside the program's own
pipeline (upload, every level, event copy-back: the `encode_batch` records'
`seconds`), i.e. bit-packing, trimming and container assembly on the host."""


def read(run):
    program = run.client.program_seconds()
    calls = run.client.call_seconds()
    if program is None or calls <= 0:
        return None
    return 100.0 * (1.0 - program / calls)
