"""Bytes and operations of the port's kernels that the cells launch, each
input byte read once and each output byte written once."""
from __future__ import annotations


def weighted_aggregate_bytes(clients: int, dim: int, itemsize: int = 4
                             ) -> int:
    """``out[D] = sum_c w[c] * x[c, D]``: the C x D models, the C f32
    weights and the D outputs."""
    return clients * dim * itemsize + clients * 4 + dim * itemsize


def flash_attention_work(batch: int, seq: int, heads: int, kv_heads: int,
                         head_dim: int, itemsize: int = 2,
                         causal: bool = True):
    """``(flops, bytes)`` of one causal flash-attention launch over
    ``[batch, seq, heads, head_dim]`` queries and ``kv_heads`` key and
    value heads: 4 * head_dim FLOPs a (query, key) pair (the two
    products), half the pairs under the causal mask (with the diagonal),
    and q, k, v read and o written once."""
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    flops = 4 * head_dim * pairs * batch * heads
    elems = batch * seq * head_dim * (2 * heads + 2 * kv_heads)
    return flops, elems * itemsize
