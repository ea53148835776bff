from repro_torch.kernels.robust_combine.ops import (
    MAX_CLIENTS, combine_rows, robust_combine, row_select_weights)
from repro_torch.kernels.robust_combine.ref import (
    merge_pairs_by_loops, oddeven_merge_pairs, robust_combine_network_ref,
    robust_combine_ref, sort_rows)

__all__ = ["MAX_CLIENTS", "combine_rows", "merge_pairs_by_loops",
           "oddeven_merge_pairs", "robust_combine",
           "robust_combine_network_ref", "robust_combine_ref",
           "row_select_weights", "sort_rows"]
