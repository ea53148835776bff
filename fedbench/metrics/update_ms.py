"""Device ms of a round's optimizer updates: the program's
``train.step.update`` spans (each local step's ``opt.update``, on CUDA
events) summed a round, the median over the traced plays' rounds
(``record["program"]``). The reader of ``update_ms.<cell kind>``."""
from fedbench.program_spans import round_median


def read(record):
    return round_median(record.get("program"), "train.step.update")
