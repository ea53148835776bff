"""The 90th percentile of the single rounds' wall times over every round
of the window (each round with its host reads)."""
import statistics


def read(record):
    w = record["window"]
    if w["rounds_per_play"] != 1:
        return None
    if len(w["play_s"]) == 1:
        return 1e3 * w["play_s"][0]
    return 1e3 * statistics.quantiles(w["play_s"], n=10,
                                      method="inclusive")[-1]
