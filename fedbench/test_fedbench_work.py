"""The frozen work arithmetic against hand counts."""
import json
import os

from fedbench.work import cnn, kernels, moe

HERE = os.path.dirname(os.path.abspath(__file__))


def _config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_cnn_forward_flops_by_hand():
    # conv 32x32x(3x3x3)x32, 16x16x(3x3x32)x64, 8x8x(3x3x64)x64, then
    # dense 1024x128 and 128x10: 8,094,976 multiply-adds
    macs = (32 * 32 * 27 * 32 + 16 * 16 * 288 * 64 + 8 * 8 * 576 * 64
            + 1024 * 128 + 128 * 10)
    assert macs == 8_094_976
    assert cnn.forward_flops(_config("fedtest-cnn")) == 16_189_952


def test_cnn_round_flops_and_aggregate_bytes():
    cfg = _config("fedtest-cnn")
    with open(os.path.join(HERE, "traffic", "paper-n20.json")) as f:
        traffic = json.load(f)
    fwd = 16_189_952
    # 20 users x 10 steps x 32 rows trained (3 forwards each), 5 testers
    # x 20 models x 256 rows, 2,048 global rows
    want = 3 * fwd * 6_400 + fwd * (25_600 + 2_048)
    work = cnn.round_work(cfg, traffic)
    assert work["round_flops"] == want
    # 20 x 188,810 f32 models, 20 f32 weights, the 188,810 f32 output
    assert work["aggregate_bytes"] == 15_860_120
    assert kernels.weighted_aggregate_bytes(20, 188_810) == 15_860_120


def test_granite_active_params_by_hand():
    cfg = _config("granite-moe-1b-a400m")
    attn = 1024 * (16 + 2 * 8) * 64 + 16 * 64 * 1024
    experts = 8 * 3 * 1024 * 512
    router = 1024 * 32
    head = 1024 * 49_155
    assert (attn, experts, router, head) == (3_145_728, 12_582_912, 32_768,
                                             50_334_720)
    assert moe.active_params(cfg) == 8 * (attn + experts + router) + head
    assert moe.active_params(cfg) == 176_425_984


def test_flash_fold_work_by_hand():
    # the cross-test fold of 2 testers x 4 models x 64 rows: [512, 64]
    # tokens, 16 query and 8 key/value heads of 64, bf16
    flops, nbytes = kernels.flash_attention_work(512, 64, 16, 8, 64)
    assert flops == 4 * 64 * (64 * 65 // 2) * 512 * 16
    assert nbytes == 512 * 64 * 64 * (2 * 16 + 2 * 8) * 2
    assert (flops, nbytes) == (4_362_076_160, 201_326_592)
