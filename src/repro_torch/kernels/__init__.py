"""Hand-written Hopper kernels of the port.

Each kernel replaces one Pallas TPU kernel of ``repro.kernels`` and lives
in its own subpackage:

* ``ops.py`` — the wrapper: checks device, dtype, shape and contiguity,
  launches the CUDA kernel for a CUDA tensor (counting launches in
  ``<op>.launches``) and runs the plain version for a CPU tensor;
* ``ref.py`` — the plain PyTorch version of the same function.

CUDA sources are in ``csrc/``, built by :mod:`repro_torch.kernels.build`.

The two LM kernels, ``flash_attention`` and ``ssd_scan``, are
``torch.library`` custom ops with a vmap rule: under the batched
cross-test's ``torch.func.vmap`` they fold the mapped dimensions into
their batch and launch once (a batch over the grid's 65,535 rows, once
a slice of that many). They have no gradient: local training
differentiates their plain-op twins, ``blockwise_attention`` and
``ssd_chunked`` (the reference's ``attention_xla`` and ``_ssd_xla``).

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
