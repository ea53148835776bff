"""An LM round's useful model FLOPs (the active experts only) over its
wall time, as a % of the card's bf16 peak (989 TFLOP/s)."""
from fedbench.readers import mfu


def read(record):
    return mfu(record)
