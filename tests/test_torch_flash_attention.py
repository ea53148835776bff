"""The port's flash_attention against the reference.

On the CPU the op runs its plain version (``attention_ref`` in
``repro_torch/kernels/flash_attention/ref.py``), held here against the
JAX package's oracle and its Pallas kernel in interpret mode on the same
numpy inputs, f32. Tolerance 2e-5: the softmax sums are taken in other
orders, and the Pallas kernel's is online. The CUDA kernel itself runs
only on a card: ``chip_smoke.py`` holds it against the plain version
there.

The op under ``torch.func.vmap`` (its fold rule) equals a loop of the op
bitwise: every (batch row, head) is computed alone. Its differentiable
twin ``blockwise_attention`` is held to the reference's ``attention_xla``
at 2e-5 forward and 1e-4 in the gradient (the backward's sums in other
orders again); the op itself refuses a gradient.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import grad, vmap  # noqa: E402

from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_pallas)
from repro.kernels.flash_attention.ops import attention_xla  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as jax_attention_ref)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, blockwise_attention, flash_attention)

TOL = 2e-5


def _inputs(B, S, T, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    return q, k, v


# (B, S, T, Hq, Hkv, D, causal, window, q_offset); S and T are multiples of
# the Pallas block (32) so the interpret-mode kernel takes them
CASES = [
    (2, 64, 64, 4, 4, 32, True, None, 0),       # group 1
    (2, 64, 64, 4, 4, 32, False, None, 0),
    (1, 64, 64, 4, 2, 32, True, None, 0),       # group 2
    (1, 64, 64, 7, 1, 32, True, None, 0),       # group 7
    (1, 64, 64, 7, 1, 32, False, None, 0),
    (1, 64, 64, 4, 2, 32, True, 8, 0),          # sliding window
    (1, 64, 64, 7, 1, 32, True, 40, 0),
    (1, 32, 96, 4, 2, 32, True, None, 64),      # q_offset, S < T
    (1, 32, 96, 4, 2, 32, True, 16, 64),
    (1, 32, 64, 4, 4, 64, False, None, 0),      # head_dim 64, S < T
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_matches_reference_and_pallas(case):
    B, S, T, Hq, Hkv, D, causal, window, q_offset = case
    q, k, v = _inputs(B, S, T, Hq, Hkv, D, seed=sum(case[:6]))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal,
                          sliding_window=window, q_offset=q_offset)
    assert got.shape == (B, S, Hq, D) and got.dtype == torch.float32
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want = np.asarray(jax_attention_ref(jq, jk, jv, causal=causal,
                                        sliding_window=window,
                                        q_offset=q_offset))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    pallas = np.asarray(flash_attention_pallas(
        jq, jk, jv, causal=causal, sliding_window=window, q_offset=q_offset,
        block_q=32, block_k=32, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("S,T,q_offset", [(13, 13, 0), (5, 37, 32),
                                          (50, 71, 3)])
def test_plain_matches_reference_at_ragged_sizes(S, T, q_offset):
    """S and T that no block divides (the CUDA kernel masks its edges)."""
    q, k, v = _inputs(2, S, T, 6, 2, 32, seed=S * 100 + T)
    for causal, window in ((True, None), (False, None), (True, 8)):
        got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal,
                            sliding_window=window, q_offset=q_offset)
        want = jax_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 sliding_window=window, q_offset=q_offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


def test_bf16_plain_matches_reference():
    """bf16 inputs, f32 softmax, bf16 output: one bf16 ulp of |out| < 1."""
    q, k, v = _inputs(1, 32, 32, 4, 2, 32, seed=7)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = jax_attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=8e-3,
                               atol=8e-3)


def test_cpu_route_launches_nothing_and_refuses_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 4, 2, 32, 0))
    before = flash_attention.launches
    flash_attention(q, k, v)
    assert flash_attention.launches == before
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :1].expand(1, 8, 3, 32), v)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, sliding_window=0)


def _bf16_kernel_arithmetic(q, k, v, *, causal, window, split_p):
    """The bf16 CUDA kernel's arithmetic, emulated in f32 on the CPU:
    64-key tiles, an online softmax over them, P rounded to bf16 before
    the P V product (with ``split_p`` as hi + lo, hi = bf16(p) and lo =
    bf16(p - hi), the kernel's two products), l summed from the unrounded
    p; a row with no key gives 0. q [S,D], k, v [T,D], one head."""
    S, T = q.shape[0], k.shape[0]
    logits = (q.float() @ k.float().T) * q.shape[1] ** -0.5
    qpos, kpos = torch.arange(S)[:, None], torch.arange(T)[None, :]
    keep = torch.ones((S, T), dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    logits = logits.masked_fill(~keep, -1e30)
    m = torch.full((S,), -1e30)
    l, acc = torch.zeros(S), torch.zeros(S, q.shape[1])
    for t0 in range(0, T, 64):
        s = logits[:, t0:t0 + 64]
        m_new = torch.maximum(m, s.amax(dim=1))
        corr, p = torch.exp(m - m_new), torch.exp(s - m_new[:, None])
        hi = p.bfloat16().float()
        p_used = hi + (p - hi).bfloat16().float() if split_p else hi
        l = l * corr + p.sum(dim=1)
        acc = acc * corr[:, None] + p_used @ v[t0:t0 + 64].float()
        m = m_new
    out = torch.where((m > -1e30)[:, None], acc / l.clamp(min=1e-30)[:, None],
                      torch.zeros(()))
    return out.bfloat16()


@pytest.mark.parametrize("split_p,holds", [(True, True), (False, False)])
def test_bf16_p_needs_hi_and_lo_to_hold_the_card_tolerance(split_p, holds):
    """chip_smoke.py holds the bf16 kernels to |err| <= 1e-3 + 8e-3
    |plain| (ATTN_TOL). P rounded to bf16 alone (2**-9 relative a weight)
    moves outputs near 0 past that on these inputs (rows that attend a
    few keys); carried as hi + lo it stays inside. Inputs: bf16 values,
    two heads' worth of rows (S = T = 150, three tiles, the last
    ragged), causal with and without a window of 8."""
    q, k, v = (torch.from_numpy(a[0, :, 0]).bfloat16()
               for a in _inputs(1, 150, 150, 1, 1, 64, seed=11))
    ratios = []
    for window in (None, 8):
        got = _bf16_kernel_arithmetic(q, k, v, causal=True, window=window,
                                      split_p=split_p)
        want = attention_ref(q[None, :, None], k[None, :, None],
                             v[None, :, None], causal=True,
                             sliding_window=window)[0, :, 0]
        err = (got.float() - want.float()).abs()
        ratios.append(float((err / (1e-3 + 8e-3 * want.float().abs()))
                            .max()))
    assert (max(ratios) <= 1.0) == holds, ratios


# ------------------------------------------ the training twin, vmap, grid
# (B, S, T, Hq, Hkv, D, causal, window, q_offset, block_q, block_k): blocks
# of the largest divisor <= the target, so S = 24 with 16 takes 12 and
# T = 40 takes 10 (ragged against the target)
TWIN_CASES = [
    (2, 32, 32, 4, 2, 16, True, None, 0, 512, 512),
    (1, 24, 24, 4, 1, 16, True, None, 0, 16, 16),
    (1, 24, 40, 6, 2, 8, True, 7, 16, 16, 16),
    (2, 30, 30, 4, 4, 8, False, None, 0, 8, 8),
]


@pytest.mark.parametrize("case", TWIN_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_blockwise_twin_matches_attention_xla(case):
    """Forward, and the gradient of a weighted sum of the output with
    respect to q, k and v (``torch.func.grad`` against ``jax.grad``)."""
    B, S, T, Hq, Hkv, D, causal, window, q_offset, bq, bk = case
    q, k, v = _inputs(B, S, T, Hq, Hkv, D, seed=sum(case[:6]))
    cot = np.random.default_rng(2).standard_normal((B, S, Hq, D)
                                                   ).astype(np.float32)
    kw = dict(causal=causal, sliding_window=window, q_offset=q_offset,
              block_q=bq, block_k=bk)

    def jloss(q, k, v):
        return jnp.sum(attention_xla(q, k, v, **kw) * cot)

    def tloss(q, k, v):
        return (blockwise_attention(q, k, v, **kw)
                * torch.from_numpy(cot)).sum()

    jargs = [jnp.asarray(a) for a in (q, k, v)]
    targs = [torch.from_numpy(a) for a in (q, k, v)]
    np.testing.assert_allclose(
        blockwise_attention(*targs, **kw).numpy(),
        np.asarray(attention_xla(*jargs, **kw)), rtol=TOL, atol=TOL)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)
    got = grad(tloss, argnums=(0, 1, 2))(*targs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


# (K, N, rows, S, Hq, Hkv, D, causal, window)
VMAP_CASES = [
    (2, 3, 2, 16, 4, 4, 32, True, None),      # nested, group 1
    (3, 2, 1, 24, 6, 2, 16, True, None),      # GQA
    (2, 2, 3, 20, 4, 1, 8, True, 5),          # GQA and a window
    (2, 2, 2, 12, 2, 2, 8, False, None),
]


@pytest.mark.parametrize("case", VMAP_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_vmap_rule_is_a_loop_of_the_op_bitwise(case):
    """Nested vmap (testers outside, models inside, as the cross-test
    nests them) against a Python loop of the op; and an unmapped k, v
    under a mapped q, which the rule expands."""
    K, N, rows, S, Hq, Hkv, D, causal, window = case
    rng = np.random.default_rng(K * 100 + N)
    q = torch.from_numpy(rng.standard_normal((K, N, rows, S, Hq, D))
                         .astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((K, N, rows, S, Hkv, D))
                             .astype(np.float32)) for _ in range(2))

    def op(q, k, v):
        return flash_attention(q, k, v, causal=causal, sliding_window=window)
    got = vmap(vmap(op))(q, k, v)
    want = torch.stack([torch.stack([op(q[i, j], k[i, j], v[i, j])
                                     for j in range(N)]) for i in range(K)])
    assert torch.equal(got, want)
    got = vmap(op, in_dims=(0, None, None))(q[0], k[0, 0], v[0, 0])
    assert torch.equal(got, torch.stack([op(q[0, j], k[0, 0], v[0, 0])
                                         for j in range(N)]))
    with pytest.raises(ValueError, match="maps q"):
        vmap(op, in_dims=(None, 0, 0))(q[0, 0], k[0], v[0])


def test_the_op_refuses_a_gradient():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 4, 2, 16, 0))
    with pytest.raises(RuntimeError, match="no gradient"):
        grad(lambda q: flash_attention(q, k, v).sum())(q)
    with pytest.raises(RuntimeError, match="no gradient"):
        vmap(grad(lambda q: flash_attention(q, k, v).sum()))(q[None])
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        assert torch.equal(flash_attention(q, k, v), attention_ref(q, k, v))


def test_launches_are_split_at_the_grid_limit(monkeypatch):
    """A grid holds at most 65,535 batch rows: a folded batch above that
    (K=5 testers x N=64 models x 256 eval rows = 81,920) takes two
    launches. The CPU route walks the same slices: with the limit cut to
    3, a batch of 8 (three slices) equals the plain version unsplit."""
    assert build.batch_slices(81_920) == [slice(0, 65_535),
                                          slice(65_535, 81_920)]
    assert build.batch_slices(65_535) == [slice(0, 65_535)]
    assert build.batch_slices(1) == [slice(0, 1)]
    q, k, v = (torch.from_numpy(a) for a in _inputs(8, 16, 16, 4, 2, 16, 5))
    want = attention_ref(q, k, v, sliding_window=6)
    monkeypatch.setattr(build, "MAX_GRID_BATCH", 3)
    assert [(s.start, s.stop) for s in build.batch_slices(8)] == [
        (0, 3), (3, 6), (6, 8)]
    assert torch.equal(flash_attention(q, k, v, sliding_window=6), want)
