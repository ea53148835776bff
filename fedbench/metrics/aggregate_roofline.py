"""``weighted_aggregate``'s share of its byte bound: the C x D models,
the C weights and the D output, each moved once at 3.35 TB/s, over the
device time of the kernel's own launches (those made inside the port's
call of its grouped kernel) a round, in the traced stretch (in the
population, in an eager round of its trainer beside the traced chunk: a
replay runs no Python). The reader of ``aggregate_roofline.<cell
kind>``."""
from fedbench.readers import span


def read(record):
    s = span(record, "weighted_aggregate")
    if s is None:
        return None
    bound_s = record["work"]["aggregate_bytes"] / record["hbm_bytes_per_s"]
    return 100.0 * bound_s * record["trace"]["span_rounds"] / s["device_s"]
