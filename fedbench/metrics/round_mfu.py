"""A CNN round's model FLOPs over its wall time, as a % of the card's
float32 peak (67 TFLOP/s)."""
from fedbench.readers import mfu


def read(record):
    return mfu(record)
