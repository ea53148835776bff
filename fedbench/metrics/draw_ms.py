"""Device ms of the cohort's draw (``PopulationTrainer.draw``) in a replayed round: the
program's ``draw`` spans, event nodes of the chunk's graph, summed over
a chunk's last replay, the median over the traced plays' chunks
(``record["program"]``). The reader of ``draw_ms.<cell kind>``."""
from fedbench.program_spans import round_median


def read(record):
    return round_median(record.get("program"), "draw", replay=True)
