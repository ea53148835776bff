"""The port's roofline arithmetic and H100 ``Chip`` against the reference
(``repro.roofline``), on the CPU.

* ``model_flops`` (active and total params), ``roofline_terms`` and
  ``collective_bytes_per_device`` equal the reference's exactly for every
  non-``fedtest`` arch x shape (full configs: both count params from
  shapes, nothing is built);
* ``TPU_V5E`` is the reference's row; ``chip_for`` picks the row by the
  device's name and takes the device's memory and shared memory.
"""
import dataclasses
import types

import pytest

pytest.importorskip("torch")

from repro.config import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.roofline import TPU_V5E as J_TPU_V5E  # noqa: E402
from repro.roofline import model_flops as j_model_flops  # noqa: E402
from repro.roofline.analysis import (  # noqa: E402
    collective_bytes_per_device as j_coll_bytes)
from repro.roofline.analysis import roofline_terms as j_roofline_terms  # noqa: E402
from repro_torch.config import INPUT_SHAPES  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.roofline import (  # noqa: E402
    H100_NVL, H100_PCIE, H100_SXM, H200, TPU_V5E, chip_for,
    collective_bytes_per_device, model_flops, roofline_terms)

ARCHS = [a for a in list_configs() if not a.startswith("fedtest-")]
COLLS = {"all-reduce": 3 * 2**20, "all-gather": 5 * 2**21,
         "reduce-scatter": 7 * 2**19, "all-to-all": 11, "collective-permute": 13}


def test_input_shapes_are_the_references():
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_terms_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for name, shape in INPUT_SHAPES.items():
        for active in (True, False):
            assert model_flops(cfg, shape, active) == \
                j_model_flops(jcfg, J_SHAPES[name], active)
        mf = model_flops(cfg, shape)
        for chip in (TPU_V5E, H100_SXM):
            for per_device in (True, False):
                args = (mf / 256, mf / 4096, 3.5e9, chip, 256, per_device)
                assert roofline_terms(*args) == j_roofline_terms(*args)


def test_collective_bytes_equal_the_reference():
    assert collective_bytes_per_device(COLLS) == j_coll_bytes(COLLS)
    assert collective_bytes_per_device({}) == j_coll_bytes({}) == 0


def test_tpu_row_is_the_references():
    got = dataclasses.asdict(TPU_V5E)
    assert got.pop("peak_flops_fp32") is None
    assert got == dataclasses.asdict(J_TPU_V5E)


@pytest.mark.parametrize("name,row", [
    ("NVIDIA H100 80GB HBM3", H100_SXM), ("NVIDIA H100 PCIe", H100_PCIE),
    ("NVIDIA H100 NVL", H100_NVL), ("NVIDIA H200", H200)])
def test_chip_for_reads_the_device(name, row):
    props = types.SimpleNamespace(name=name, total_memory=85_017_755_648,
                                  shared_memory_per_multiprocessor=233_472)
    chip = chip_for(props)
    assert chip.hbm_bytes == 85_017_755_648
    assert chip.vmem_bytes == 233_472
    assert dataclasses.replace(chip, hbm_bytes=row.hbm_bytes,
                               vmem_bytes=row.vmem_bytes) == row
    # NVLink 4 on the SXM cards: 900 GB/s both ways, 450 one way
    assert H100_SXM.ici_link_bw == 450e9
    assert (H100_SXM.peak_flops_bf16, H100_SXM.peak_flops_fp32,
            H100_SXM.hbm_bw) == (989e12, 67e12, 3.35e12)


def test_chip_for_refuses_an_unknown_card():
    with pytest.raises(ValueError, match="no published peaks"):
        chip_for(types.SimpleNamespace(name="NVIDIA A100-SXM4-80GB",
                                       total_memory=1))
