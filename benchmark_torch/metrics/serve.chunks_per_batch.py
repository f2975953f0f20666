"""serve.chunks_per_batch: chunks the server's micro-batcher put into each
device batch in the window (``/v1/stats`` counters: chunks answered over
batches run, deltas over the window). Layer: serving micro-batcher. Source:
the program's counters."""


def read(run):
    if run.serve_batches <= 0:
        return None
    return run.serve_chunks / run.serve_batches
