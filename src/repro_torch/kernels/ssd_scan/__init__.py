from repro_torch.kernels.ssd_scan.ops import ssd_chunked, ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_decode_ref, ssd_ref

__all__ = ["ssd_chunked", "ssd_decode_ref", "ssd_ref", "ssd_scan"]
