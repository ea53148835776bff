"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit): the yardstick of
every share of a peak or a roofline the benchmark reports. A frozen copy
of ``repro_torch.roofline.hw.H100_SXM``."""

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
