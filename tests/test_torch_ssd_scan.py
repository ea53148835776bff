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
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels.ssd_scan.kernel import ssd_scan_pallas  # noqa: E402
from repro.kernels.ssd_scan.ops import _ssd_xla  # noqa: E402
from repro.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_decode_ref as jax_ssd_decode_ref, ssd_ref as jax_ssd_ref)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_decode_ref, ssd_ref, ssd_scan)

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
