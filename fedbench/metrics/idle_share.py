"""The share of an untraced round in which the device runs nothing:
1 - the device's busy seconds a round in the traced stretch over the
window's (untraced) seconds a round. The profiler slows the host's side
of an eager round, not the device's, so the traced stretch's own idle
share would read the profiler's cost. The reader of
``idle_share.<cell kind>`` for host-paced cells."""
from fedbench.readers import idle_share_of_round


def read(record):
    return idle_share_of_round(record)
