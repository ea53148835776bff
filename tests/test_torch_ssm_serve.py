"""The port's Mamba2 (ssm) serve path against the reference.

``mamba2-2.7b`` through ``reduce_for_smoke`` (2 layers, d_model 256,
state 16 in heads of 32, chunk 32) in f32: params made by the JAX package
go through ``params_from_reference``, the same numpy tokens go through
both models (the reference with ``ssm_impl="naive"``, its sequential
oracle; the port on the CPU, where ``ssd_scan`` runs its sequential plain
version). Tolerance rtol=1e-4, atol=1e-5 on logits and states: XLA and
PyTorch sum the projections in other orders. The teacher-forced checks
use 3e-4, as ``tests/test_decode_consistency.py`` does.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduce_for_smoke as jreduce_for_smoke  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models.ssm import ssm_full as jssm_full  # noqa: E402
from repro_torch.config import ModelConfig, reduce_for_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.ssm import ssm_full  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

ARCH = "mamba2-2.7b"
RTOL, ATOL = 1e-4, 1e-5
TF_TOL = 3e-4


@functools.lru_cache(maxsize=None)
def _jmodel(dtype="float32"):
    cfg = jreduce_for_smoke(jget_config(ARCH)).replace(dtype=dtype)
    model = jbuild_model(cfg, ssm_impl="naive")
    return model, jax.jit(model.init)


def _pair(seed=0):
    jmodel, jinit = _jmodel()
    jparams = jinit(jax.random.PRNGKey(seed))
    cfg = reduce_for_smoke(get_config(ARCH)).replace(dtype="float32")
    tmodel = build_model(cfg)
    tparams = params_from_reference(_np(jparams), "cpu", model=tmodel)
    return jmodel, tmodel, jparams, tparams


def _tokens(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_close(got, want, **tol):
    flat_want = jax.tree_util.tree_leaves(want)
    flat_got = tree_leaves(got)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


def test_config_matches_reference_field_for_field():
    for port, ref in ((get_config(ARCH), jget_config(ARCH)),
                      (reduce_for_smoke(get_config(ARCH)),
                       jreduce_for_smoke(jget_config(ARCH)))):
        for f in dataclasses.fields(ModelConfig):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert (port.d_inner, port.ssm_heads, port.is_attention_free) == (
            ref.d_inner, ref.ssm_heads, ref.is_attention_free)
        assert not port.uses_attention(0) and not ref.uses_attention(0)
        assert build_model(port).param_count() == ref.param_count()


def test_full_width_param_count_and_dims():
    cfg = get_config(ARCH)
    assert build_model(cfg).param_count() == 2_702_579_200
    assert (cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_ngroups, cfg.ssm_chunk) == (5120, 80, 64, 128, 1, 256)


def test_ssm_config_needs_a_state():
    with pytest.raises(ValueError, match="state size"):
        ModelConfig(name="x", family="ssm", num_layers=2, d_model=64,
                    vocab_size=64)


@pytest.mark.parametrize("S", [12, 45])
def test_forward_and_prefill_match_reference(S):
    """S = 12 fits in one chunk of 32; S = 45 leaves a ragged second."""
    jmodel, tmodel, jparams, tparams = _pair()
    toks = _tokens(tmodel.cfg, 2, S)
    want = np.asarray(jax.jit(jmodel.forward_train)(
        jparams, {"tokens": jnp.asarray(toks)})[0])
    got = tmodel.forward_train(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape == (2, S, tmodel.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

    jlogits, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, cache_len=64))(
        jparams, {"tokens": jnp.asarray(toks)})
    tlogits, tcache = tmodel.prefill(tparams,
                                     {"tokens": torch.from_numpy(toks)},
                                     cache_len=64)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    cfg = tmodel.cfg
    slot = tcache["layers"]["slot_0"]
    assert slot["conv"].shape == (cfg.num_layers, 2, cfg.ssm_conv_width - 1,
                                  cfg.d_inner + 2 * cfg.ssm_state)
    assert slot["ssm"].shape == (cfg.num_layers, 2, cfg.ssm_heads,
                                 cfg.ssm_head_dim, cfg.ssm_state)
    assert slot["ssm"].dtype == torch.float32
    assert tcache["length"].tolist() == [S, S]
    _assert_tree_close(tcache, _np(jcache), rtol=RTOL, atol=ATOL)


def test_short_prompt_pads_the_conv_state():
    """S = 2 < W - 1 = 3: the conv state is the prompt's pre-conv rows
    behind one zero row, as the reference pads it."""
    jmodel, tmodel, jparams, tparams = _pair(seed=1)
    toks = _tokens(tmodel.cfg, 2, 2, seed=2)
    _, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b))(
        jparams, {"tokens": jnp.asarray(toks)})
    _, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    conv = tcache["layers"]["slot_0"]["conv"]
    assert not bool(conv[:, :, 0].any()) and bool(conv[:, :, 1:].any())
    _assert_tree_close(tcache, _np(jcache), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("return_state", [False, True])
def test_ssm_block_matches_reference(return_state):
    """One Mamba2 block on its own (layer 0's params), with and without
    the serve hand-off."""
    jmodel, tmodel, jparams, tparams = _pair(seed=3)
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["layers"]["slot_0"]["mamba"])
    tp = tree_map(lambda a: a[0], tparams["layers"]["slot_0"]["mamba"])
    x = np.random.default_rng(4).standard_normal(
        (2, 37, tmodel.cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, v: jssm_full(p, jmodel.cfg, v, impl="naive",
                                          return_state=return_state))(
        jp, jnp.asarray(x))
    got = ssm_full(tp, tmodel.cfg, torch.from_numpy(x),
                   return_state=return_state)
    if return_state:       # (out, (conv_state, ssm_state)) in both
        pairs = [(got[0], want[0]), *zip(got[1], want[1])]
    else:
        pairs = [(got, want)]
    for g, w in pairs:
        _assert_tree_close(g, w, rtol=RTOL, atol=ATOL)


def test_two_decode_steps_match_reference():
    jmodel, tmodel, jparams, tparams = _pair(seed=2)
    toks = _tokens(tmodel.cfg, 3, 42, seed=3)
    jprefill = jax.jit(lambda p, b: jmodel.prefill(p, b))
    jdecode = jax.jit(jmodel.decode_step)
    _, jcache = jprefill(jparams, {"tokens": jnp.asarray(toks[:, :40])})
    _, tcache = tmodel.prefill(tparams,
                               {"tokens": torch.from_numpy(toks[:, :40])})
    states = [t.data_ptr() for t in tree_leaves(tcache["layers"])]
    for i in (40, 41):
        jlogits, jcache = jdecode(jparams, jcache,
                                  jnp.asarray(toks[:, i:i + 1]))
        tlogits, tcache = tmodel.decode_step(
            tparams, tcache, torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=RTOL, atol=ATOL)
        _assert_tree_close(tcache, _np(jcache), rtol=RTOL, atol=ATOL)
    assert tcache["length"].tolist() == [42, 42, 42]
    # the states are written in place, as the KV cache is
    assert [t.data_ptr() for t in tree_leaves(tcache["layers"])] == states


@pytest.mark.parametrize("S", [16, 40])
def test_decode_matches_teacher_forced(S):
    """The port's own consistency, as tests/test_decode_consistency.py
    holds the reference's: prefill + two decode steps give the logits of a
    full forward over the same tokens (S = 40 leaves a ragged chunk)."""
    _, tmodel, _, tparams = _pair(seed=4)
    B = 2
    toks = torch.from_numpy(_tokens(tmodel.cfg, B, S + 2, seed=5))
    full = tmodel.forward_train(tparams, {"tokens": toks})
    _, cache = tmodel.prefill(tparams, {"tokens": toks[:, :S]})
    lg1, cache = tmodel.decode_step(tparams, cache, toks[:, S:S + 1])
    lg2, cache = tmodel.decode_step(tparams, cache, toks[:, S + 1:S + 2])
    assert float((full[:, S] - lg1[:, 0]).abs().max()) < TF_TOL
    assert float((full[:, S + 1] - lg2[:, 0]).abs().max()) < TF_TOL
    assert cache["length"].tolist() == [S + 2] * B


def test_greedy_serve_loop_matches_reference():
    """The port's serve loop (``launch/serve.py``) against the reference's
    greedy loop on the same params and prompt: each token equal wherever
    the reference's top-two logit margin exceeds the tolerance; past the
    first near-tie the two continuations may differ."""
    jmodel, tmodel, jparams, tparams = _pair(seed=9)
    B, S, gen_len = 3, 33, 8
    toks = _tokens(tmodel.cfg, B, S, seed=10)
    res = serve_mod.serve(tmodel, tparams,
                          {"tokens": torch.from_numpy(toks)}, gen_len, 0.0,
                          torch.Generator().manual_seed(0))
    got = res["tokens"].numpy()
    assert got.shape == (B, gen_len) and got.dtype == np.int32

    logits, cache = jax.jit(lambda p, b: jmodel.prefill(p, b))(
        jparams, {"tokens": jnp.asarray(toks)})
    jdecode = jax.jit(jmodel.decode_step)
    live = np.ones(B, bool)          # rows not yet past a near-tie
    checked = 0
    for i in range(gen_len):
        last = np.asarray(logits[:, -1])
        top2 = np.sort(last, axis=-1)[:, -2:]
        want = last.argmax(-1)
        clear = (top2[:, 1] - top2[:, 0]) > 10 * ATOL
        rows = live & clear
        np.testing.assert_array_equal(got[rows, i], want[rows])
        checked += int(rows.sum())
        live &= clear
        if i + 1 < gen_len:
            logits, cache = jdecode(jparams, cache,
                                    jnp.asarray(got[:, i:i + 1]))
    assert checked >= B * gen_len // 2, checked


def test_bf16_reference_tree_keeps_f32_leaves():
    """The mixed-dtype mamba tree converts leaf for leaf: bf16 projections
    and conv, f32 ``dt_bias``, ``A_log``, ``D`` and norm scales, each
    equal to the reference's value."""
    jmodel, jinit = _jmodel(dtype="bfloat16")
    jparams = _np(jinit(jax.random.PRNGKey(11)))
    tmodel = build_model(reduce_for_smoke(get_config(ARCH)))
    assert tmodel.dtype == torch.bfloat16
    tparams = params_from_reference(jparams, "cpu", model=tmodel)
    mamba = tparams["layers"]["slot_0"]["mamba"]
    assert all(mamba[k].dtype == torch.float32
               for k in ("dt_bias", "A_log", "D"))
    assert mamba["norm_scale"]["scale"].dtype == torch.float32
    assert mamba["in_proj"].dtype == torch.bfloat16
    assert tparams["embed"].dtype == torch.bfloat16
    want_dtypes = jax.tree_util.tree_map(lambda a: str(a.dtype), jparams)
    got_dtypes = tree_map(lambda t: str(t.dtype).replace("torch.", ""),
                          tparams)
    assert got_dtypes == want_dtypes
    _assert_tree_close(tparams, jparams, rtol=0, atol=0)


def test_port_init_matches_the_reference_tree():
    """The port's own init: the reference's tree, shapes and dtypes, and
    its deterministic leaves (A_log, D, biases, norm scales)."""
    jmodel, jinit = _jmodel(dtype="bfloat16")
    jparams = _np(jinit(jax.random.PRNGKey(0)))
    tmodel = build_model(reduce_for_smoke(get_config(ARCH)))
    tparams = tmodel.init(torch.Generator().manual_seed(0))
    assert tree_map(lambda t: tuple(t.shape), tparams) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    assert tree_map(lambda t: str(t.dtype).replace("torch.", ""),
                    tparams) == jax.tree_util.tree_map(
                        lambda a: str(a.dtype), jparams)
    tm, jm = tparams["layers"]["slot_0"]["mamba"], \
        jparams["layers"]["slot_0"]["mamba"]
    for k in ("D", "dt_bias", "conv_b"):
        np.testing.assert_array_equal(tm[k].float().numpy(),
                                      np.asarray(jm[k], np.float32))
    # torch.linspace and jnp.linspace may round a point differently
    np.testing.assert_allclose(tm["A_log"].numpy(), np.asarray(jm["A_log"]),
                               rtol=1e-6, atol=0)


def test_serve_cli_runs_on_cpu():
    res = serve_mod.main(["--device", "cpu", "--smoke", "--arch", ARCH,
                          "--batch", "2", "--prompt-len", "40", "--gen", "3"])
    assert res["tokens"].shape == (2, 3)
    assert res["cache"]["length"].tolist() == [42, 42]
    assert res["cache"]["layers"]["slot_0"]["ssm"].dtype == torch.float32
