"""The window's wall time over the rounds it completed."""
from fedbench.readers import round_s


def read(record):
    return 1e3 * round_s(record)
