"""The port's decode_attention and merge_partials against the reference.

On the CPU the op runs its plain version (``decode_attention_ref``), held
here against the JAX package's oracle and its Pallas kernel in interpret
mode on the same numpy inputs, f32, for both ``out`` and ``lse``.
Tolerance 2e-5: the softmax sums are taken in other orders, and the
Pallas kernel's is online. The CUDA kernels run only on a card:
``chip_smoke.py`` holds them against the plain version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_pallas)
from repro.kernels.decode_attention.ops import (  # noqa: E402
    merge_partials as jax_merge_partials)
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as jax_decode_ref)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_ref, merge_partials)
from repro_torch.kernels.decode_attention.ops import num_splits  # noqa: E402

TOL = 2e-5


def _inputs(B, T, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    return q, k, v


# (T, Hq, Hkv, D, lengths, window); T is a multiple of the Pallas block (32)
CASES = [
    (64, 4, 4, 32, (64, 1), None),              # group 1, length 1
    (64, 8, 4, 32, (17, 64), None),             # group 2, ragged
    (96, 7, 1, 32, (1, 50, 95), None),          # group 7
    (64, 8, 1, 64, (33, 2), None),              # group 8, head_dim 64
    (96, 4, 2, 32, (96, 40, 1), 8),             # window
    (64, 7, 1, 32, (64, 30), 100),              # window wider than the cache
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(x).replace(" ", "") for x in c))
def test_plain_matches_reference_and_pallas(case):
    T, Hq, Hkv, D, lengths, window = case
    B = len(lengths)
    q, k, v = _inputs(B, T, Hq, Hkv, D, seed=T + Hq * 7 + D)
    lens = np.asarray(lengths, np.int32)
    out, lse = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(lens),
                                window=window)
    assert out.shape == (B, Hq, D) and lse.shape == (B, Hq)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(lens))
    for wo, wl in (jax_decode_ref(*jargs, window=window),
                   decode_attention_pallas(*jargs, window=window, block_k=32,
                                           interpret=True)):
        np.testing.assert_allclose(out.numpy(), np.asarray(wo), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(wl), rtol=TOL,
                                   atol=TOL)


def test_merge_partials_over_split_caches_equals_unsplit():
    """Split the cache into shards of keys, attend each shard with its own
    lengths, merge by LSE: the unsplit result, and the reference's merge.
    Every shard holds a valid key; a shard without one enters with
    lse = -inf and drops out."""
    B, T, Hq, Hkv, D = 3, 96, 8, 2, 32
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, T, Hq, Hkv, D, 11))
    lengths = torch.tensor([96, 70, 65], dtype=torch.int32)
    full_out, full_lse = decode_attention(q, k, v, lengths)
    outs, lses = [], []
    for s0, s1 in ((0, 32), (32, 64), (64, 96)):
        shard_len = (lengths - s0).clamp(0, s1 - s0).to(torch.int32)
        o, lse = decode_attention(q, k[:, s0:s1].contiguous(),
                                  v[:, s0:s1].contiguous(), shard_len)
        outs.append(o)
        lses.append(lse)
    outs, lses = torch.stack(outs), torch.stack(lses)
    got = merge_partials(outs, lses)
    np.testing.assert_allclose(got.numpy(), full_out.numpy(), rtol=TOL,
                               atol=TOL)
    want = jax_merge_partials(jnp.asarray(outs.numpy()),
                              jnp.asarray(lses.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # a fourth shard with no valid key: lse -inf, out 0, no weight
    empty = torch.cat([outs, torch.zeros_like(outs[:1])])
    empty_lse = torch.cat([lses, torch.full_like(lses[:1], float("-inf"))])
    np.testing.assert_allclose(merge_partials(empty, empty_lse).numpy(),
                               full_out.numpy(), rtol=TOL, atol=TOL)


def test_plain_is_the_reference_on_bf16_inputs():
    """bf16 cache, f32 softmax, bf16 out: one bf16 ulp of |out| < 1."""
    q, k, v = _inputs(2, 32, 4, 2, 32, seed=5)
    lens = np.asarray([32, 9], np.int32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out, lse = decode_attention_ref(tq, tk, tv, torch.from_numpy(lens))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    wo, wl = jax_decode_ref(jq, jk, jv, jnp.asarray(lens))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(wo, np.float32),
                               rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(lse.numpy(), np.asarray(wl), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("B,Hkv,T,sms,want", [
    (8, 2, 545, 132, 5),        # the serve path: bounded by 128 keys a split
    (32, 2, 32768, 132, 17),    # long cache: eight blocks an SM
    (1, 1, 40, 132, 1),         # a short cache stays whole
    (64, 8, 4096, 132, 3),
    (1, 2, 32768, 132, 256),    # one sequence: 512 blocks of 128 keys
    (8, 2, 128, 132, 1),        # one split of two tiles
    (8, 2, 129, 132, 2),
])
def test_num_splits(B, Hkv, T, sms, want):
    assert num_splits(B, Hkv, T, sms) == want


def test_cpu_route_launches_nothing_and_refuses_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 16, 4, 2, 32, 0))
    lengths = torch.tensor([16, 3], dtype=torch.int32)
    before = (decode_attention.launches, decode_attention.merge_launches)
    decode_attention(q, k, v, lengths)
    assert (decode_attention.launches,
            decode_attention.merge_launches) == before
    with pytest.raises(TypeError):
        decode_attention(q.double(), k.double(), v.double(), lengths)
    with pytest.raises(ValueError):
        decode_attention(q, k, v, lengths[:1])
    with pytest.raises(ValueError):
        decode_attention(q, k, v, lengths, window=0)
