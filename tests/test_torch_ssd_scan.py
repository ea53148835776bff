"""The port's ssd_scan against the reference.

On the CPU the op runs its plain version (the sequential ``ssd_ref`` in
``repro_torch/kernels/ssd_scan/ref.py``), held here against the JAX
package's sequential oracle, its Pallas kernel in interpret mode (where
the chunk divides S) and its chunked XLA form ``_ssd_xla``, on the same
numpy inputs. Tolerances: 1e-5 between the two sequential recurrences
(the same products, summed in other orders); 1e-3 against the chunked
forms, as ``tests/test_kernels_ssd.py`` holds chunked against sequential:
a chunk's decays are differences of a prefix sum of dt A, which loses
about 1e-4 relative in fp32. bf16 outputs: one bf16 ulp (2**-7 relative)
plus slack. The CUDA kernel itself runs only on a card: ``chip_smoke.py``
holds it against the plain version there.

The op under ``torch.func.vmap`` (its fold rule, with each client's own
A and D as a row a folded batch row) equals a loop of the op bitwise, and
``ssd_ref`` with ``[Bt, H]`` A and D equals its calls row by row. The
differentiable twin ``ssd_chunked`` is held to the reference's
``_ssd_xla`` (the same chunked algorithm, its sums in other orders) at
the chunked forms' 1e-3, forward and gradient; the op itself refuses a
gradient.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from torch.func import grad, vmap  # noqa: E402

from repro.kernels.ssd_scan.kernel import ssd_scan_pallas  # noqa: E402
from repro.kernels.ssd_scan.ops import _ssd_xla  # noqa: E402
from repro.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_decode_ref as jax_ssd_decode_ref, ssd_ref as jax_ssd_ref)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_chunked, ssd_decode_ref, ssd_ref, ssd_scan)

SEQ_TOL = dict(rtol=1e-5, atol=1e-5)
CHUNK_TOL = dict(rtol=1e-3, atol=1e-3)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)

# (Bt, S, H, P, G, N): the three shapes of tests/test_kernels_ssd.py, then
# the serve path's head and state widths at a few heads (P=64, N=128) and
# the smoke config's (P=32, N=16)
SHAPES = [
    (1, 64, 2, 16, 1, 8),
    (2, 128, 4, 32, 2, 16),
    (1, 96, 6, 16, 3, 8),      # H/G = 2, S not a power of two
    (1, 64, 4, 64, 1, 128),
    (2, 64, 8, 32, 2, 16),
]


def _inputs(shape, seed, *, mamba_init=False):
    """x, dt, A, B, C, D as numpy f32. ``mamba_init``: A and dt as the
    Mamba2 block draws them at init (A = -linspace(1, 16, H), dt =
    softplus of a unit normal), so a chunk's cum reaches the hundreds."""
    Bt, S, H, P, G, N = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, H)))).astype(np.float32)
    if mamba_init:
        A = -np.linspace(1.0, 16.0, H, dtype=np.float32)
    else:
        A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    B = rng.standard_normal((Bt, S, G, N)).astype(np.float32)
    C = rng.standard_normal((Bt, S, G, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    return x, dt, A, B, C, D


def _t(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_plain_matches_reference_sequential(shape):
    arrs = _inputs(shape, seed=sum(shape))
    y, h = ssd_ref(*_t(arrs))
    yr, hr = jax_ssd_ref(*_j(arrs))
    assert y.shape == shape[:4] and y.dtype == torch.float32
    assert h.shape == (shape[0], shape[2], shape[3], shape[5])
    assert h.dtype == torch.float32
    _close(y, yr, **SEQ_TOL)
    _close(h, hr, **SEQ_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_op_matches_pallas_and_xla(shape, chunk):
    """ssd_scan on the CPU route against the chunked XLA form at the same
    chunk, and against the Pallas kernel in interpret mode where the chunk
    divides S (its grid needs whole chunks)."""
    arrs = _inputs(shape, seed=sum(shape) + chunk)
    launches = ssd_scan.launches
    y, h = ssd_scan(*_t(arrs), chunk=chunk)
    assert ssd_scan.launches == launches      # the CPU route launches nothing
    if shape[1] % chunk == 0:
        yp, hp = ssd_scan_pallas(*_j(arrs), chunk=chunk, interpret=True)
        _close(y, yp, **CHUNK_TOL)
        _close(h, hp, **CHUNK_TOL)
    yx, hx = _ssd_xla(*_j(arrs), chunk=chunk)
    _close(y, yx, **CHUNK_TOL)
    _close(h, hx, **CHUNK_TOL)


@pytest.mark.parametrize("S,chunk", [(77, 32), (45, 64), (20, 256),
                                     (1, 32)])
def test_ragged_and_short_sequences(S, chunk):
    """S not a multiple of the chunk, and S shorter than one chunk: the
    op takes any S (the Pallas wrapper asserts S % chunk == 0); held to
    the sequential oracle and the chunked XLA form, which cuts S into its
    largest divisor <= chunk."""
    shape = (2, S, 4, 32, 2, 16)
    arrs = _inputs(shape, seed=S + chunk)
    y, h = ssd_scan(*_t(arrs), chunk=chunk)
    assert y.shape == shape[:4]
    yr, hr = jax_ssd_ref(*_j(arrs))
    _close(y, yr, **SEQ_TOL)
    _close(h, hr, **SEQ_TOL)
    yx, hx = _ssd_xla(*_j(arrs), chunk=chunk)
    _close(y, yx, **CHUNK_TOL)
    _close(h, hx, **CHUNK_TOL)


def test_mamba_init_dynamics_within_chunk_tolerance():
    """A = -linspace(1, 16, H) and dt ~ softplus(N(0, 1)), as the model
    draws them: the chunked forms stay within 1e-3 of the sequential
    recurrence although a chunk's cum reaches the hundreds."""
    shape = (1, 128, 8, 32, 1, 16)
    arrs = _inputs(shape, seed=3, mamba_init=True)
    y, h = ssd_scan(*_t(arrs), chunk=64)
    yp, hp = ssd_scan_pallas(*_j(arrs), chunk=64, interpret=True)
    _close(y, yp, **CHUNK_TOL)
    _close(h, hp, **CHUNK_TOL)


def test_bf16_inputs():
    """bf16 x, B, C: y comes back in bf16, the state in f32. The port and
    the reference upcast the same bf16 values, so the sequential outputs
    agree to one bf16 ulp; the Pallas kernel (chunked) within the bf16
    tolerance."""
    shape = (1, 64, 4, 32, 2, 16)
    x, dt, A, B, C, D = _inputs(shape, seed=2)
    xb, Bb, Cb = (a.astype(ml_dtypes.bfloat16) for a in (x, B, C))
    tx, tB, tC = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                  for a in (xb, Bb, Cb))
    tdt, tA, tD = _t((dt, A, D))
    y, h = ssd_scan(tx, tdt, tA, tB, tC, tD, chunk=32)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    yr, hr = jax_ssd_ref(jnp.asarray(xb), jnp.asarray(dt), jnp.asarray(A),
                         jnp.asarray(Bb), jnp.asarray(Cb), jnp.asarray(D))
    assert yr.dtype == jnp.bfloat16
    _close(y, yr, rtol=8e-3, atol=1e-3)
    _close(h, hr, **SEQ_TOL)
    yp, hp = ssd_scan_pallas(jnp.asarray(xb), jnp.asarray(dt),
                             jnp.asarray(A), jnp.asarray(Bb),
                             jnp.asarray(Cb), jnp.asarray(D), chunk=32,
                             interpret=True)
    _close(y, yp, **BF16_TOL)
    _close(h, hp, **CHUNK_TOL)


def test_init_state_matches_reference():
    shape = (2, 24, 4, 16, 2, 8)
    arrs = _inputs(shape, seed=5)
    h0 = np.random.default_rng(6).standard_normal(
        (2, 4, 16, 8)).astype(np.float32)
    y, h = ssd_ref(*_t(arrs), init_state=torch.from_numpy(h0))
    yr, hr = jax_ssd_ref(*_j(arrs), init_state=jnp.asarray(h0))
    _close(y, yr, **SEQ_TOL)
    _close(h, hr, **SEQ_TOL)


def test_decode_recurrence_continues_scan():
    """The state of a scan over S-1 rows feeds the decode step: its output
    and state equal the last row of a scan over all S rows, and the port's
    decode step equals the reference's on the same state."""
    shape = (2, 64, 4, 16, 2, 8)
    S = shape[1]
    x, dt, A, B, C, D = _t(_inputs(shape, seed=3))
    y_all, h_all = ssd_ref(x, dt, A, B, C, D)
    _, h_pre = ssd_scan(x[:, :S - 1], dt[:, :S - 1], A, B[:, :S - 1],
                        C[:, :S - 1], D, chunk=21)
    step = (x[:, -1], dt[:, -1], A, B[:, -1], C[:, -1], D)
    y_dec, h_dec = ssd_decode_ref(*step, h_pre)
    _close(y_dec, y_all[:, -1].numpy(), **SEQ_TOL)
    _close(h_dec, h_all.numpy(), **SEQ_TOL)
    yr, hr = jax_ssd_decode_ref(*(jnp.asarray(t.numpy()) for t in step),
                                jnp.asarray(h_pre.numpy()))
    _close(y_dec, yr, **SEQ_TOL)
    _close(h_dec, hr, **SEQ_TOL)


def _bad(case):
    """Valid inputs with one thing wrong."""
    x, dt, A, B, C, D = _t(_inputs((1, 8, 4, 16, 2, 8), seed=7))
    kw = dict(chunk=4)
    if case == "H % G":
        B, C = B[:, :, :1].expand(1, 8, 3, 8), C[:, :, :1].expand(1, 8, 3, 8)
    elif case == "C shape":
        C = C[:, :4]
    elif case == "dt shape":
        dt = dt[:, :, :2]
    elif case == "A shape":
        A = A[:2]
    elif case == "empty S":
        x, dt, B, C = x[:, :0], dt[:, :0], B[:, :0], C[:, :0]
    elif case == "chunk 0":
        kw = dict(chunk=0)
    elif case == "float16 x":
        x, B, C = x.half(), B.half(), C.half()
    elif case == "mixed x, B":
        B = B.to(torch.bfloat16)
    elif case == "float64 dt":
        dt = dt.double()
    elif case == "bf16 D":
        D = D.to(torch.bfloat16)
    return (x, dt, A, B, C, D), kw


@pytest.mark.parametrize("case,exc", [
    ("H % G", ValueError), ("C shape", ValueError), ("dt shape", ValueError),
    ("A shape", ValueError), ("empty S", ValueError), ("chunk 0", ValueError),
    ("float16 x", TypeError), ("mixed x, B", TypeError),
    ("float64 dt", TypeError), ("bf16 D", TypeError)])
def test_bad_inputs_are_refused(case, exc):
    args, kw = _bad(case)
    launches = ssd_scan.launches
    with pytest.raises(exc):
        ssd_scan(*args, **kw)
    assert ssd_scan.launches == launches


def _bf16_kernel_arithmetic(x, dt, A, B, C, D, chunk, split):
    """The bf16 CUDA kernel's arithmetic, emulated in f32 on the CPU: per
    chunk the f32 prefix sum cum of dt A; S = C B^T, exact (bf16 inputs,
    f32 sums); L_ij = exp(cum_i - cum_j) dt_j masked to i >= j before exp;
    y = (S o L) x + exp(cum) (C h0^T) + D x, cast to bf16; the state
    h <- exp(cum_last) h + (w o x)^T B, w_j = exp(cum_last - cum_j) dt_j.
    The tensor cores take bf16 operands, so each f32 operand of a product
    (``"S o L"``, ``"h0"``, ``"w o x"``) is rounded to bf16, or, where
    ``split`` names it, carried as hi + lo (hi = bf16(v), lo = bf16(v -
    hi), the kernel's two products)."""
    Bt, S, H, P = x.shape
    rep = H // B.shape[2]
    xf = x.float()
    Bf, Cf = (t.float().repeat_interleave(rep, 2) for t in (B, C))

    def operand(t, name):
        hi = t.bfloat16().float()
        return hi + (t - hi).bfloat16().float() if name in split else hi

    h = torch.zeros((Bt, H, P, B.shape[3]))
    ys = []
    for c0 in range(0, S, chunk):
        rows = slice(c0, min(S, c0 + chunk))
        xc, Bc, Cc = xf[:, rows], Bf[:, rows], Cf[:, rows]
        dc = dt[:, rows].permute(0, 2, 1)                       # [Bt,H,q]
        cum = torch.cumsum(dc * A[:, None], dim=2)
        keep = torch.ones((dc.shape[2],) * 2, dtype=torch.bool).tril()
        diff = torch.where(keep, cum[..., :, None] - cum[..., None, :], 0.0)
        L = torch.where(keep, torch.exp(diff) * dc[..., None, :], 0.0)
        scores = torch.einsum("bihn,bjhn->bhij", Cc, Bc)
        y = torch.einsum("bhij,bjhp->bihp", operand(scores * L, "S o L"), xc)
        y = y + (torch.exp(cum).permute(0, 2, 1)[..., None]
                 * torch.einsum("bihn,bhpn->bihp", Cc, operand(h, "h0")))
        ys.append(y + D[:, None] * xc)
        w = torch.exp(cum[..., -1:] - cum) * dc
        wx = operand(w[..., None] * xc.permute(0, 2, 1, 3), "w o x")
        h = (torch.exp(cum[..., -1])[..., None, None] * h
             + torch.einsum("bhjp,bjhn->bhpn", wx, Bc))
    return torch.cat(ys, dim=1).bfloat16(), h


@functools.lru_cache(maxsize=None)
def _served_widths_case():
    """Three chunks of 256 (the last ragged) at the served head and state
    widths (P=64, N=128, one group), A and dt as the model draws them, in
    bf16, with the sequential plain version's outputs."""
    x, dt, A, B, C, D = _t(_inputs((1, 600, 4, 64, 1, 128), seed=11,
                                   mamba_init=True))
    args = (x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(), D)
    return args, ssd_ref(*args)


@pytest.mark.parametrize("split,holds", [
    (("S o L", "h0", "w o x"), True),
    (("h0", "w o x"), False),
    (("S o L", "w o x"), False),
    (("S o L", "h0"), False),
], ids=["all-hi-lo", "S-o-L-bf16", "h0-bf16", "w-o-x-bf16"])
def test_bf16_operands_need_hi_and_lo_to_hold_the_card_tolerance(split,
                                                                 holds):
    """chip_smoke.py holds the bf16 kernel's y to rtol = atol = 1e-2 and
    its f32 state to 1e-3 against the sequential plain version. Each of
    the three f32 operands the tensor cores take (S o L, h0, w o x),
    rounded to bf16 alone (2**-9 relative), moves y or the state past that
    on the served widths; carried as hi + lo, all three hold. The kernel
    carries all three as hi + lo."""
    args, (yr, hr) = _served_widths_case()
    y, h = _bf16_kernel_arithmetic(*args, chunk=256, split=split)
    ratio_y = float(((y.float() - yr.float()).abs()
                     / (BF16_TOL["atol"] + BF16_TOL["rtol"]
                        * yr.float().abs())).max())
    ratio_h = float(((h - hr).abs() / (CHUNK_TOL["atol"]
                                       + CHUNK_TOL["rtol"] * hr.abs())).max())
    assert (max(ratio_y, ratio_h) <= 1.0) == holds, (ratio_y, ratio_h)


# --------------------------------------- the training twin, vmap, A/D rows
@pytest.mark.parametrize("shape,chunk", [
    ((2, 32, 4, 16, 2, 8), 16), ((1, 30, 4, 8, 1, 4), 8),
    ((2, 21, 6, 8, 3, 4), 32), ((1, 64, 4, 32, 1, 16), 256)],
    ids=lambda c: "-".join(map(str, c)) if isinstance(c, tuple) else str(c))
def test_chunked_twin_matches_ssd_xla(shape, chunk):
    """Forward (y and the final state), and the gradient of a weighted sum
    of both with respect to all six inputs (``torch.func.grad`` against
    ``jax.grad``); S = 30 with chunk 8 takes chunks of 6, S = 21 one of
    21."""
    arrs = _inputs(shape, seed=sum(shape) + chunk)
    rng = np.random.default_rng(chunk)
    cy = rng.standard_normal(shape[:4]).astype(np.float32)
    ch = rng.standard_normal((shape[0], shape[2], shape[3], shape[5])
                             ).astype(np.float32)
    y, h = ssd_chunked(*_t(arrs), chunk=chunk)
    yx, hx = _ssd_xla(*_j(arrs), chunk=chunk)
    _close(y, yx, **CHUNK_TOL)
    _close(h, hx, **CHUNK_TOL)

    def jloss(*a):
        y, h = _ssd_xla(*a, chunk=chunk)
        return jnp.sum(y * cy) + jnp.sum(h * ch)

    def tloss(*a):
        y, h = ssd_chunked(*a, chunk=chunk)
        return (y * torch.from_numpy(cy)).sum() + (h * torch.from_numpy(
            ch)).sum()
    want = jax.grad(jloss, argnums=tuple(range(6)))(*_j(arrs))
    got = grad(tloss, argnums=tuple(range(6)))(*_t(arrs))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        _close(g, w, **CHUNK_TOL)


def test_plain_takes_a_and_d_by_row():
    """``ssd_ref`` with ``[Bt, H]`` A and D (a vmapped eval's folded
    clients) equals its calls row by row with each row's ``[H]``."""
    x, dt, A, B, C, D = _t(_inputs((3, 12, 4, 8, 2, 4), seed=9))
    rng = np.random.default_rng(10)
    A_rows = -torch.from_numpy(np.exp(rng.standard_normal((3, 4)))
                               .astype(np.float32))
    D_rows = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    y, h = ssd_ref(x, dt, A_rows, B, C, D_rows)
    for b in range(3):
        yb, hb = ssd_ref(x[b:b + 1], dt[b:b + 1], A_rows[b], B[b:b + 1],
                         C[b:b + 1], D_rows[b])
        assert torch.equal(y[b:b + 1], yb) and torch.equal(h[b:b + 1], hb)
    assert not torch.equal(y, ssd_ref(x, dt, A, B, C, D)[0])


@pytest.mark.parametrize("shape", [(2, 3, 2, 10, 4, 8, 2, 4),
                                   (3, 2, 1, 33, 6, 16, 3, 8)],
                         ids=lambda s: "-".join(map(str, s)))
def test_vmap_rule_is_a_loop_of_the_op_bitwise(shape):
    """Nested vmap as the cross-test nests it: testers outside mapping
    the activations, models inside mapping them and each model's own A
    and D; against a Python loop of the op with each client's [H] A and
    D. Then the serve path's shared [H] A and D under one map, an unmapped
    dt expanded, and a mapped A with an unmapped x refused."""
    K, N, Bt, S, H, P, G, Ns = shape
    rng = np.random.default_rng(sum(shape))

    def rnd(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x, B, C = rnd(K, N, Bt, S, H, P), rnd(K, N, Bt, S, G, Ns), rnd(
        K, N, Bt, S, G, Ns)
    dt = torch.nn.functional.softplus(rnd(K, N, Bt, S, H))
    A, D = -torch.exp(rnd(N, H)), rnd(N, H)

    def op(x, dt, A, B, C, D):
        return ssd_scan(x, dt, A, B, C, D, chunk=8)

    def tester(x, dt, B, C):
        return vmap(op)(x, dt, A, B, C, D)
    y, h = vmap(tester)(x, dt, B, C)
    for i in range(K):
        for j in range(N):
            yw, hw = op(x[i, j], dt[i, j], A[j], B[i, j], C[i, j], D[j])
            assert torch.equal(y[i, j], yw) and torch.equal(h[i, j], hw)
    y, h = vmap(op, in_dims=(0, None, None, 0, 0, None))(
        x[0], dt[0, 0], A[0], B[0], C[0], D[0])
    for j in range(N):
        yw, hw = op(x[0, j], dt[0, 0], A[0], B[0, j], C[0, j], D[0])
        assert torch.equal(y[j], yw) and torch.equal(h[j], hw)
    with pytest.raises(ValueError, match="maps x"):
        vmap(op, in_dims=(None, None, 0, None, None, None))(
            x[0, 0], dt[0, 0], A, B[0, 0], C[0, 0], D[0])


def test_the_op_refuses_a_gradient():
    x, dt, A, B, C, D = _t(_inputs((1, 8, 4, 16, 2, 8), seed=4))
    with pytest.raises(RuntimeError, match="no gradient"):
        grad(lambda x: ssd_scan(x, dt, A, B, C, D, chunk=4)[0].sum())(x)
    with pytest.raises(RuntimeError, match="no gradient"):
        vmap(grad(lambda a: ssd_scan(x, dt, a, B, C, D, chunk=4)[0].sum()))(
            A[None])


def test_launches_are_split_at_the_grid_limit(monkeypatch):
    """The CPU route walks the kernel's launch slices: with the limit
    cut to 2, a batch of 5 with [Bt, H] A and D (three slices, each with
    its rows of A and D) equals the plain version unsplit."""
    x, dt, A, B, C, D = _t(_inputs((5, 9, 4, 8, 2, 4), seed=12))
    A_rows = A[None].repeat(5, 1) * torch.arange(1, 6)[:, None]
    D_rows = D[None].repeat(5, 1) - torch.arange(5)[:, None]
    want = ssd_ref(x, dt, A_rows, B, C, D_rows)
    monkeypatch.setattr(build, "MAX_GRID_BATCH", 2)
    got = ssd_scan(x, dt, A_rows, B, C, D_rows, chunk=4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
