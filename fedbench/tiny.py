"""The cells at CPU-test sizes: the same code paths, the same traffic
kinds, a few clients, rows and steps, and (for the LM) a narrow model."""
from __future__ import annotations

import os

from fedbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CNN = {"fed": {"num_users": 4, "num_testers": 2, "num_malicious": 1,
               "local_steps": 2},
       "train": {"batch_size": 8},
       "data": {"train_rows": 40, "test_rows": 16, "global_rows": 32,
                "server_rows": 16},
       "eval_rows": 16, "global_rows": 32, "trace_plays": 1}
# a vocabulary of 32 and a high rate, so that a round moves the losses
# far enough for a fault to show at this size
LM = {"data": {"seq_len": 16, "train_rows": 8, "test_rows": 8,
               "global_rows": 8, "server_rows": 4, "topic_vocab": 4,
               "skew": 0.9},
      "eval_rows": 8, "global_rows": 8, "fed": {"local_steps": 4},
      "train": {"batch_size": 4, "lr": 0.1}, "trace_plays": 1}
LM_MODEL = {"hidden_size": 64, "num_attention_heads": 4,
            "num_key_value_heads": 2, "head_dim": 16,
            "intermediate_size": 32, "num_local_experts": 8,
            "num_experts_per_tok": 2, "vocab_size": 32,
            "num_hidden_layers": 2, "dtype": "float32",
            "port_replace": {"num_layers": 2, "d_model": 64,
                             "num_heads": 4, "num_kv_heads": 2,
                             "head_dim": 16, "d_ff": 32, "vocab_size": 32,
                             "num_experts": 8, "num_experts_per_tok": 2,
                             "dtype": "float32"}}
POPULATION = {"fed": {"num_users": 200, "num_testers": 4,
                      "num_malicious": 40, "local_steps": 2, "cohort": 8,
                      "participation": 0.04},
              "cohort": 8, "rounds_per_call": 2, "crosstest_block": 4,
              "train": {"batch_size": 8},
              "data": {"global_rows": 16, "server_rows": 8},
              "eval_rows": 16, "global_rows": 16, "checked_rounds": 2,
              "trace_plays": 1, "timer_plays": 1}
# the paper's CNN on 8 x 8 images, narrow: the same layers and code paths
CNN_MODEL = {"image_size": 8, "cnn_channels": [4, 8, 8], "cnn_hidden": 16,
             "params": 1306,
             "port_replace": {"image_size": 8, "cnn_channels": (4, 8, 8),
                              "cnn_hidden": 16}}
SHRINK = {"fedtest-cnn.dense-n20": (CNN, CNN_MODEL),
          "fedtest-cnn.population-100k": (POPULATION, CNN_MODEL),
          "granite-moe-1b-a400m.lm-round": (LM, LM_MODEL)}


def cell(name: str, root: str = ROOT, **extra) -> harness.Cell:
    traffic, model = SHRINK[name]
    return harness.Cell(root, name, shrink={**traffic, **extra},
                        config_shrink=model)
