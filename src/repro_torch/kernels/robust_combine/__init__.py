from repro_torch.kernels.robust_combine.ops import (
    MAX_CLIENTS, combine_rows, robust_combine, row_select_weights)
from repro_torch.kernels.robust_combine.ref import (
    REGISTER_PADS, SEGMENT, merge_pairs_by_loops, merge_stages,
    oddeven_merge_pairs, padded_rows, robust_combine_network_ref,
    robust_combine_padded_ref, robust_combine_ref, sort_rows,
    sort_rows_staged, stage_pairs)

__all__ = ["MAX_CLIENTS", "REGISTER_PADS", "SEGMENT", "combine_rows",
           "merge_pairs_by_loops", "merge_stages", "oddeven_merge_pairs",
           "padded_rows", "robust_combine", "robust_combine_network_ref",
           "robust_combine_padded_ref", "robust_combine_ref",
           "row_select_weights", "sort_rows", "sort_rows_staged",
           "stage_pairs"]
