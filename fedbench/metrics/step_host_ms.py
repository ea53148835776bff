"""Host ms of one local step: the median of the program's ``train.step``
spans in the traced plays (``record["program"]``), what a step costs
the host to dispatch. Beside ``train_ms`` over the steps it says whether
training is paced by the host. The reader of ``step_host_ms.<cell
kind>``."""
from fedbench.program_spans import span_median


def read(record):
    return span_median(record.get("program"), "train.step")
