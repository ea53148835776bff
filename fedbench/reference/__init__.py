"""Plain PyTorch references of what the cells run: a model family's
forward and loss (``cnn.py``, ``moe.py``), the FedTest round over it
(``fedtest.py``) and the comparison that decides ``correct``
(``compare.py``). They import nothing of the port and take nothing the
port made: the benchmark's own inputs and seed only."""
