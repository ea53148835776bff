"""Target-hardware constants, per chip (the port's side of
``repro/roofline/hw.py``).

``Chip`` keeps the reference's fields and adds ``peak_flops_fp32``. On
an NVIDIA card they read:

* ``peak_flops_bf16`` — dense bf16 on the tensor cores, and
  ``peak_flops_fp32`` — f32 outside them (NVIDIA data sheets);
* ``hbm_bw`` — HBM bytes/s (data sheet);
* ``ici_link_bw`` — the NVLink bandwidth of one GPU in one direction, the
  link of the production mesh's ``model`` axis (one 8-card NVLink domain,
  ``launch/mesh.py``). The data sheets count both directions (900 GB/s
  for NVLink 4 on the SXM cards, 600 GB/s on the PCIe and NVL cards'
  bridges), so the field is half that;
* ``hbm_bytes`` — device memory, and ``vmem_bytes`` — the twin of a
  TPU core's VMEM, the shared memory of one SM: the data sheet's figures
  in the constants, the device's own in :func:`chip_for`.

``TPU_V5E`` is the reference's row, kept so that its numbers can be set
beside the port's; no H100 figure derives from it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

GiB = 1024 ** 3
KiB = 1024


@dataclasses.dataclass(frozen=True)
class Chip:
    name: str
    peak_flops_bf16: float      # FLOP/s
    hbm_bw: float               # bytes/s
    ici_link_bw: float          # bytes/s per link, one direction
    hbm_bytes: float
    vmem_bytes: float
    peak_flops_fp32: Optional[float] = None   # FLOP/s


TPU_V5E = Chip(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    ici_link_bw=50e9,
    hbm_bytes=16 * GiB,
    vmem_bytes=128 * 1024 ** 2,
)

# the published H100 and H200 rows (NVIDIA data sheets, dense)
H100_SXM = Chip(name="h100_sxm", peak_flops_bf16=989e12, hbm_bw=3.35e12,
                ici_link_bw=450e9, hbm_bytes=80 * GiB,
                vmem_bytes=228 * KiB, peak_flops_fp32=67e12)
H100_PCIE = Chip(name="h100_pcie", peak_flops_bf16=756e12, hbm_bw=2.0e12,
                 ici_link_bw=300e9, hbm_bytes=80 * GiB,
                 vmem_bytes=228 * KiB, peak_flops_fp32=51e12)
H100_NVL = Chip(name="h100_nvl", peak_flops_bf16=835e12, hbm_bw=3.9e12,
                ici_link_bw=300e9, hbm_bytes=94 * GiB,
                vmem_bytes=228 * KiB, peak_flops_fp32=60e12)
H200 = Chip(name="h200", peak_flops_bf16=989e12, hbm_bw=4.8e12,
            ici_link_bw=450e9, hbm_bytes=141 * GiB, vmem_bytes=228 * KiB,
            peak_flops_fp32=67e12)

# a device name -> its row: the first key found in the name, in this order
CHIPS = (("H100 PCIe", H100_PCIE), ("H100 NVL", H100_NVL),
         ("H100", H100_SXM), ("H200", H200))


def chip_for(props) -> Chip:
    """The row of the card ``props`` describes (``torch.cuda.
    get_device_properties``), its ``hbm_bytes`` and ``vmem_bytes`` the
    device's own: ``total_memory`` and the shared memory of one SM. A card
    no row names raises."""
    for key, chip in CHIPS:
        if key in props.name:
            smem = getattr(props, "shared_memory_per_multiprocessor", None)
            return dataclasses.replace(
                chip, hbm_bytes=float(props.total_memory),
                vmem_bytes=float(smem or chip.vmem_bytes))
    raise ValueError(f"no published peaks for the card {props.name!r}; "
                     f"known: {[key for key, _ in CHIPS]}")
