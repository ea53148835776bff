"""``flash_attention``'s share of its roofline in the cross-test fold and
the global eval: a round's launches' bound (the larger of the operations
at 989 TFLOP/s and the bytes at 3.35 TB/s, a launch) over the device time
of the launches made inside the port's ``repro_torch::flash_attention``
op in the traced stretch."""
from fedbench.readers import span


def read(record):
    s = span(record, "repro_torch::flash_attention")
    if s is None:
        return None
    plays = record["trace"]["plays"] * record["window"]["rounds_per_play"]
    return 100.0 * record["work"]["flash_bound_s"] * plays / s["device_s"]
