"""Device ms of the attack's keyed noise (``KeyedNoise.block``) in a replayed round: the
program's ``noise`` spans, event nodes of the chunk's graph, summed over
a chunk's last replay, the median over the traced plays' chunks
(``record["program"]``). The reader of ``noise_ms.<cell kind>``."""
from fedbench.program_spans import round_median


def read(record):
    return round_median(record.get("program"), "noise", replay=True)
