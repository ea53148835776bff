"""Device ms of a round's local training (``backend.train``), from CUDA
events around the call in eager rounds after the traced stretch (the
median round). The reader of ``train_ms.<cell kind>``."""
from fedbench.readers import step_ms


def read(record):
    return step_ms(record, "train")
