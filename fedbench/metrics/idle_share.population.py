"""The share of the traced stretch in which no kernel, copy or set ran
on the device: 1 - the union of the device's intervals in the
``torch.profiler`` trace over the stretch's seconds. A replayed chunk
runs no Python, so the profiler does not slow it; its busy time a round
reads a little above the untraced round's, so the share of an untraced
round (``idle_share.py``) would come out below 0."""
from fedbench.readers import idle_share


def read(record):
    return idle_share(record)
