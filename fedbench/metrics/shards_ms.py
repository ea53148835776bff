"""Device ms of the gather of its keyed shards (``PopulationTrainer._play_cohort``) in a replayed round: the
program's ``shards`` spans, event nodes of the chunk's graph, summed over
a chunk's last replay, the median over the traced plays' chunks
(``record["program"]``). The reader of ``shards_ms.<cell kind>``."""
from fedbench.program_spans import round_median


def read(record):
    return round_median(record.get("program"), "shards", replay=True)
