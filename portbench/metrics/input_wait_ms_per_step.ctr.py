"""Host ms a step between one chunk's replay and the next chunk's start,
over the whole window of a CTR cell: the wait for the prefetch worker's
next chunk and its staging (``data/prefetch.py``), the epochs' restarts
included."""


def read(record, config, traffic):
    return 1e3 * record.input_wait_s / record.steps
