"""The window's wall time over the rounds it completed: chunks of
replays of one CUDA graph of the population round, each chunk with its
host reads."""
from fedbench.readers import round_s


def read(record):
    return 1e3 * round_s(record)
