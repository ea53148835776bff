"""Device ms of a round's cross-testing (``backend.cross_test``), from
CUDA events around the call in eager rounds after the traced stretch
(the median round). The reader of ``cross_test_ms.<cell kind>``."""
from fedbench.readers import step_ms


def read(record):
    return step_ms(record, "cross_test")
