"""Hand-written Hopper kernels of the port.

Each kernel replaces one Pallas TPU kernel of ``repro.kernels`` and lives
in its own subpackage:

* ``ops.py`` — the wrapper: checks device, dtype, shape and contiguity,
  launches the CUDA kernel for a CUDA tensor (counting launches in
  ``<op>.launches``) and runs the plain version for a CPU tensor;
* ``ref.py`` — the plain PyTorch version of the same function.

CUDA sources are in ``csrc/``, built by :mod:`repro_torch.kernels.build`.

Kernels:
* ``weighted_aggregate`` — the FedTest server's score-weighted N-way
  model reduction, a whole param tree in one launch (CUDA C++,
  ``csrc/weighted_aggregate.cu``).
* ``robust_combine`` — the per-coordinate trimmed mean / median of the
  ``*_coord`` aggregators, a sorting network per column, in registers up
  to 64 clients and in shared memory above (CUDA C++,
  ``csrc/robust_combine.cu``).
* ``dequant_aggregate`` — the int8 compressor's fused dequantise and
  weighted sum (CUDA C++, ``csrc/dequant_aggregate.cu``).
* ``flash_attention`` — GQA attention over a sequence with causal and
  sliding-window masks, the LM prefill (CUDA C++,
  ``csrc/flash_attention.cu``).
* ``decode_attention`` — one query token a sequence over a KV cache,
  split-K with a merge kernel, the LM decode step (CUDA C++,
  ``csrc/decode_attention.cu``); ``merge_partials`` is plain torch.
* ``ssd_scan`` — the Mamba2 SSD chunked scan, blocks walking a (batch,
  head)'s chunks, bf16 products on the tensor cores, the ssm prefill
  (CUDA C++, ``csrc/ssd_scan.cu``);
  its single-token decode ``ssd_decode_ref`` is plain torch.
"""
