"""The port's compressors and dequant_aggregate against the reference.

Encode and decode run on the same numpy update and error-feedback row in
both packages: int8's codes and scales and topk's payload are equal
(both frameworks round half to even and pick the same coordinates), and
lowrank's decoded update is close (QR may flip the signs of columns,
which ``U V^T`` does not see). On the CPU ``dequant_aggregate`` runs its
plain version, held against the reference's oracle and its Pallas kernel
in interpret mode; the CUDA kernel itself runs only on a card
(``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.dequant_aggregate.kernel import (  # noqa: E402
    dequant_aggregate_pallas as j_dqagg_pallas)
from repro.kernels.dequant_aggregate.ops import (  # noqa: E402
    dequant_aggregate as j_dequant_aggregate)
from repro.kernels.dequant_aggregate.ref import (  # noqa: E402
    dequant_aggregate_ref as j_dqagg_ref)
from repro.strategies import COMPRESSORS as J_COMPRESSORS  # noqa: E402
from repro_torch.kernels.dequant_aggregate import (  # noqa: E402
    dequant_aggregate, dequant_aggregate_ref)
from repro_torch.kernels.weighted_aggregate import (  # noqa: E402
    weighted_aggregate)
from repro_torch.strategies import COMPRESSORS  # noqa: E402

SPECS = [("identity", {}), ("topk", {"k": 0.05}), ("topk", {"k": 17}),
         ("int8", {}), ("int8", {"chunk": 64}),
         ("lowrank", {"rank": 2}), ("lowrank", {"rank": 4, "iters": 3})]
EXACT = ("identity", "topk", "int8")
# f32 dequantise and weighted sum, summed in another order
TOL = dict(rtol=1e-6, atol=1e-6)


def _build(name, kwargs, dim):
    return (COMPRESSORS.build(name, kwargs, dict(dim=dim)),
            J_COMPRESSORS.build(name, kwargs, dict(dim=dim)))


def _rows(n, dim, seed, scale=1e-2):
    return (np.random.default_rng(seed).standard_normal((n, dim))
            * scale).astype(np.float32)


def test_registry_names_are_the_reference_names():
    assert COMPRESSORS.names() == J_COMPRESSORS.names()


@pytest.mark.parametrize("name,kwargs", SPECS)
def test_encode_decode_match_reference(name, kwargs):
    dim = 601
    comp, jcomp = _build(name, kwargs, dim)
    update, state = _rows(1, dim, 1)[0], _rows(1, dim, 2, 1e-3)[0]
    payload, new_state = comp.encode(torch.from_numpy(state),
                                     torch.from_numpy(update))
    jpayload, jnew_state = jcomp.encode(jnp.asarray(state),
                                        jnp.asarray(update))
    got, want = comp.decode(payload).numpy(), np.asarray(
        jcomp.decode(jpayload))
    assert got.shape == (dim,) and got.dtype == np.float32
    if name in EXACT:
        assert sorted(payload) == sorted(jpayload)
        for key in ("q", "scales", "values", "dense"):
            if key in payload:
                assert payload[key].numpy().dtype == np.asarray(
                    jpayload[key]).dtype
                np.testing.assert_array_equal(payload[key].numpy(),
                                              np.asarray(jpayload[key]))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(new_state.numpy(),
                                      np.asarray(jnew_state))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(new_state.numpy(),
                                   np.asarray(jnew_state), rtol=1e-4,
                                   atol=1e-5)
    if name == "topk":
        np.testing.assert_array_equal(
            np.sort(payload["indices"].numpy()),
            np.sort(np.asarray(jpayload["indices"])))


@pytest.mark.parametrize("name,kwargs", SPECS)
def test_batched_encode_is_row_by_row_encode(name, kwargs):
    """The round encodes all clients at once; each row sees the
    arithmetic of a one-row encode."""
    dim, n = 300, 4
    comp, _ = _build(name, kwargs, dim)
    updates = torch.from_numpy(_rows(n, dim, 3))
    states = torch.from_numpy(_rows(n, dim, 4, 1e-3))
    payloads, new_states = comp.encode(states, updates)
    decoded = comp.decode(payloads)
    assert decoded.shape == (n, dim) and new_states.shape == (n, dim)
    for i in range(n):
        payload, new_state = comp.encode(states[i], updates[i])
        if name in EXACT:
            assert torch.equal(decoded[i], comp.decode(payload))
            assert torch.equal(new_states[i], new_state)
        else:
            torch.testing.assert_close(decoded[i], comp.decode(payload),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,kwargs", SPECS)
def test_error_feedback_telescopes(name, kwargs):
    """sum_t decoded_t + residual_T == sum_t update_t: nothing the
    compressor drops is lost, it is only deferred."""
    dim, rounds = 601, 6
    comp, _ = _build(name, kwargs, dim)
    state = comp.init_state(1)[0]
    total_sent = torch.zeros((dim,))
    total_raw = torch.zeros((dim,))
    for t in range(rounds):
        u = torch.from_numpy(_rows(1, dim, 100 + t)[0])
        payload, state = comp.encode(state, u)
        total_sent = total_sent + comp.decode(payload)
        total_raw = total_raw + u
    np.testing.assert_allclose((total_sent + state).numpy(),
                               total_raw.numpy(), atol=1e-5)
    if name != "identity":
        one = comp.payload_bytes(payload)
        assert one < 4 * dim, (name, one)


def test_ctor_and_shape_validation():
    with pytest.raises(ValueError):
        COMPRESSORS.build("identity", {}, dict(dim=0))
    with pytest.raises(ValueError):
        COMPRESSORS.build("topk", {"k": 0.0}, dict(dim=100))
    with pytest.raises(ValueError):
        COMPRESSORS.build("int8", {"chunk": 0}, dict(dim=100))
    with pytest.raises(ValueError):
        COMPRESSORS.build("lowrank", {"rank": 0}, dict(dim=100))
    comp = COMPRESSORS.build("identity", {}, dict(dim=12))
    with pytest.raises(ValueError, match="flat"):
        comp.encode(torch.zeros((12,)), torch.zeros((3, 4)))


# ------------------------------------------------------ dequant_aggregate
def _payload(C, M, chunk, seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(size=(C,)).astype(np.float32)
    q = rng.integers(-127, 128, size=(C, M)).astype(np.int8)
    s = rng.uniform(1e-4, 1e-2, size=(C, M // chunk)).astype(np.float32)
    return w, s, q


@pytest.mark.parametrize("C,M,chunk,bm", [(4, 1024, 256, 512),
                                          (3, 512, 64, 128),
                                          (1, 256, 256, 256),
                                          (20, 1536, 256, 512)])
def test_dequant_plain_matches_reference(C, M, chunk, bm):
    w, s, q = _payload(C, M, chunk, seed=C + M)
    got = dequant_aggregate(torch.from_numpy(w), torch.from_numpy(s),
                            torch.from_numpy(q), chunk)
    assert got.dtype == torch.float32 and got.shape == (M,)
    wj, sj, qj = jnp.asarray(w), jnp.asarray(s), jnp.asarray(q)
    for want in (j_dqagg_ref(wj, sj, qj, chunk),
                 j_dqagg_pallas(wj, sj, qj, chunk=chunk, block_m=bm,
                                interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("c,nchunks", [(1, 1), (2, 5), (5, 9), (6, 3)])
def test_dequant_plain_matches_reference_padding_route(c, nchunks):
    """The reference's ops pads M up to a block multiple; the port has
    nothing to pad, and both agree."""
    chunk = 64
    w, s, q = _payload(c, nchunks * chunk, chunk, seed=c * 31 + nchunks)
    got = dequant_aggregate(torch.from_numpy(w), torch.from_numpy(s),
                            torch.from_numpy(q), chunk)
    want = j_dequant_aggregate(jnp.asarray(w), jnp.asarray(s),
                               jnp.asarray(q), chunk=chunk, impl="pallas",
                               block_m=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_int8_aggregate_matches_decode_then_weighted_aggregate():
    dim, C = 700, 5
    comp, jcomp = _build("int8", {}, dim)
    updates = torch.from_numpy(_rows(C, dim, 40))
    payloads, _ = comp.encode(comp.init_state(C), updates)
    decoded = comp.decode(payloads)
    w = torch.softmax(torch.arange(C, dtype=torch.float32), 0)
    fused = comp.aggregate(payloads, decoded, w)
    assert fused.shape == (dim,)
    torch.testing.assert_close(fused, weighted_aggregate(decoded, w), **TOL)
    # and the reference's fused step on the same payloads
    jpayloads, _ = jax.vmap(jcomp.encode)(jnp.zeros((C, dim)),
                                          jnp.asarray(updates.numpy()))
    want = jcomp.aggregate(jpayloads, None, jnp.asarray(w.numpy()),
                           impl="naive")
    np.testing.assert_allclose(fused.numpy(), np.asarray(want), **TOL)


def test_cpu_input_runs_plain_version_without_counting():
    w, s, q = _payload(3, 512, 256, seed=0)
    args = (torch.from_numpy(w), torch.from_numpy(s), torch.from_numpy(q))
    before = dequant_aggregate.launches
    assert torch.equal(dequant_aggregate(*args, chunk=256),
                       dequant_aggregate_ref(*args, 256))
    assert dequant_aggregate.launches == before


@pytest.mark.parametrize("w_shape,s_shape,q_shape,q_dtype,s_dtype,err", [
    ((3,), (3, 2), (3, 500), torch.int8, torch.float32, ValueError),
    ((3,), (3, 3), (3, 512), torch.int8, torch.float32, ValueError),
    ((4,), (3, 2), (3, 512), torch.int8, torch.float32, ValueError),
    ((3,), (3, 2), (512,), torch.int8, torch.float32, ValueError),
    ((3,), (3, 2), (3, 512), torch.int16, torch.float32, TypeError),
    ((3,), (3, 2), (3, 512), torch.int8, torch.float64, TypeError),
])
def test_dequant_wrapper_refuses_bad_inputs(w_shape, s_shape, q_shape,
                                            q_dtype, s_dtype, err):
    with pytest.raises(err):
        dequant_aggregate(torch.ones(w_shape), torch.ones(s_shape,
                                                          dtype=s_dtype),
                          torch.zeros(q_shape, dtype=q_dtype), chunk=256)


def test_dequant_non_cpu_non_cuda_tensor_raises():
    with pytest.raises(ValueError, match="cuda or cpu"):
        dequant_aggregate(torch.empty((2,), device="meta"),
                          torch.empty((2, 1), device="meta"),
                          torch.empty((2, 256), dtype=torch.int8,
                                      device="meta"))
