"""Runnable examples of the port, twins of the reference's ``examples/``
(inside the package, since the port imports nothing outside it):

  PYTHONPATH=src python -m repro_torch.examples.quickstart [agg] [attack]
  PYTHONPATH=src python -m repro_torch.examples.fedtest_cifar [--full]
  PYTHONPATH=src python -m repro_torch.examples.federated_llm [--malicious 1]

All run on the card unless given ``--device cpu``.
"""
