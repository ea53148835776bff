"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of FedTest.

Run one cell on the card:

    python3 fedbench/run.py --workload fedtest-cnn.dense-n20 --seed 7 \\
        --seconds 20 --trace 0

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the model's sizes, its source and its cuts;
* ``traffic/<traffic>.json``: the data shards and the federation one
  generator (``traffic.py``) and the round driver read;
* ``workloads/<cell>.json``: the configuration and traffic of a cell, its
  environment and the limits of the comparison that decides ``correct``;
* ``metrics/<metric>.py``: one reader a metric (``read(record)``);
* ``work/<family>.py``: the FLOPs and bytes of a round and of a kernel,
  from shapes alone.

The yardstick is frozen here: the traffic generator, the weights, the H100
peaks (``peaks.py``), the work arithmetic, the trace reduction
(``trace.py``) and the plain references (``reference/``), which import
nothing of the port.
"""
