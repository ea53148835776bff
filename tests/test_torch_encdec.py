"""The port's encdec family (``whisper-base``) against the reference.

At ``reduce_for_smoke`` size in f32 (2 encoder and 2 decoder layers,
d_model 256, 4 heads of 32, 64 frames, a 128-row position table): params
made by the JAX package go through ``params_from_reference``, the same
numpy tokens and frames go through both models (the reference with
``attn_impl="naive"``, the port on the CPU, where its attention ops run
their plain versions). Tolerance rtol=1e-4, atol=1e-5: XLA and PyTorch
sum the projections in other orders; the port's teacher-forced decode
against its own full forward at 3e-4, as
``tests/test_decode_consistency.py`` holds the reference's.

Also here: the building blocks whisper brings (LayerNorm with the biased
variance, the ``[sin | cos]`` table, the tanh-form GELU), each shown
apart from the form it could be mistaken for; that whisper applies no
RoPE; ``ModelConfig``'s field set against the reference's; the serve CLI
on the CPU and its refusal without a card; the position-table
``ValueError``; the train CLI's refusal of the LM round for both new
families.

Torch runs on one thread here: these small ops lose far more to thread
hand-offs than they gain when the suite's other workers share the cores.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.config import ModelConfig as JModelConfig  # noqa: E402
from repro.config import reduce_for_smoke as jreduce  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models.encdec import encode as jencode  # noqa: E402
from repro_torch.config import ModelConfig, reduce_for_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch.train import build as train_build  # noqa: E402
from repro_torch.launch.train import parse_args as train_args  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common, mlp  # noqa: E402
from repro_torch.models.encdec import encode  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

ARCH = "whisper-base"
RTOL, ATOL = 1e-4, 1e-5
TF_TOL = 3e-4
MAX_TARGET = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jmodel():
    cfg = jreduce(jget_config(ARCH)).replace(dtype="float32")
    model = jbuild_model(cfg, attn_impl="naive",
                         max_target_positions=MAX_TARGET)
    return model, jax.jit(model.init)


def _pair(seed=0):
    jmodel, jinit = _jmodel()
    jparams = jinit(jax.random.PRNGKey(seed))
    cfg = reduce_for_smoke(get_config(ARCH)).replace(dtype="float32")
    tmodel = build_model(cfg, max_target_positions=MAX_TARGET)
    tparams = params_from_reference(_np(jparams), "cpu", model=tmodel)
    return jmodel, tmodel, jparams, tparams


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, B, S, seed=1):
    """numpy tokens [B,S] and stub frames [B, encoder_seq, D] (N(0, 1) x
    0.02, as ``stub_embeddings`` draws them), for both packages."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size,
                                   size=(B, S)).astype(np.int32),
            "frames": (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
                       * 0.02).astype(np.float32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_tree_close(got, want, **tol):
    flat_want = jax.tree_util.tree_leaves(want)
    flat_got = tree_leaves(got)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


# ------------------------------------------------------------ building blocks
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference_biased_variance(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 64)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    jx = jnp.asarray(x, dtype)
    want = np.asarray(jcommon.layer_norm(
        {k: jnp.asarray(v) for k, v in p.items()}, jx, 1e-5), np.float32)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = common.layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            tx, 1e-5)
    assert got.dtype == tx.dtype
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == "float32" else dict(
        rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    # the unbiased variance (torch's default) is off by more than that
    if dtype == "float32":
        xf = torch.from_numpy(x)
        mu = xf.mean(-1, keepdim=True)
        unbiased = ((xf - mu) * torch.rsqrt(xf.var(-1, keepdim=True) + 1e-5)
                    * torch.from_numpy(p["scale"])
                    + torch.from_numpy(p["bias"]))
        assert not np.allclose(unbiased.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seq,dim", [(64, 256), (100, 512), (7, 2)])
def test_sinusoidal_positions_match_reference_sin_then_cos(seq, dim):
    """Up to 100 rows: past that, XLA's f32 ``exp`` on the CPU (one ulp
    off the rounded exact value at 22 of whisper's 256 timescales, where
    torch's is off at 1) moves row 1499's arguments by up to 1.2e-4."""
    want = np.asarray(jcommon.sinusoidal_positions(seq, dim))
    got = common.sinusoidal_positions(seq, dim)
    assert got.shape == (seq, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if dim > 2:   # the interleaved layout differs
        inter = torch.stack([got[:, :dim // 2], got[:, dim // 2:]],
                            dim=-1).reshape(seq, dim)
        assert not np.allclose(inter.numpy(), want, rtol=RTOL, atol=ATOL)


def test_gelu_mlp_matches_reference_tanh_form():
    rng = np.random.default_rng(2)
    D, H = 32, 64
    p = {"w_in": rng.standard_normal((D, H)).astype(np.float32) * 0.3,
         "b_in": rng.standard_normal(H).astype(np.float32),
         "w_out": rng.standard_normal((H, D)).astype(np.float32) * 0.3,
         "b_out": rng.standard_normal(D).astype(np.float32)}
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    want = np.asarray(jmlp.gelu_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x)))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = mlp.gelu_mlp(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    erf = F.gelu(torch.from_numpy(x) @ tp["w_in"] + tp["b_in"]) @ \
        tp["w_out"] + tp["b_out"]
    assert not np.allclose(erf.numpy(), want, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ configs
def test_modelconfig_fields_are_the_references():
    assert ([(f.name, f.default) for f in dataclasses.fields(ModelConfig)
             if f.name not in ("num_layers", "d_model")]
            == [(f.name, f.default) for f in dataclasses.fields(JModelConfig)
                if f.name not in ("num_layers", "d_model")])
    assert ({f.name for f in dataclasses.fields(ModelConfig)}
            == {f.name for f in dataclasses.fields(JModelConfig)})


def test_config_matches_reference_field_for_field():
    for port, ref in ((get_config(ARCH), jget_config(ARCH)),
                      (reduce_for_smoke(get_config(ARCH)),
                       jreduce(jget_config(ARCH)))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert get_config(ARCH).param_count() == 70_915_584 == \
        jget_config(ARCH).param_count()
    assert (reduce_for_smoke(get_config(ARCH)).param_count()
            == jreduce(jget_config(ARCH)).param_count())


def test_modelconfig_checks_encoder_dims():
    with pytest.raises(ValueError, match="encoder dims"):
        ModelConfig(name="x", family="encdec", num_layers=2, d_model=64,
                    num_heads=2, num_kv_heads=1, head_dim=32, d_ff=64,
                    vocab_size=64)


# ------------------------------------------------------------ the model
def test_param_tree_matches_reference():
    jmodel, tmodel, jparams, tparams = _pair()
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), _np(jparams))
            == {k: v for k, v in _shapes(tmodel.param_shapes()).items()})
    assert tparams["dec_pos"].shape[0] == max(
        tmodel.cfg.decoder_max_position, MAX_TARGET)
    assert tparams["decoder"]["norm3"]["bias"].dtype == torch.float32


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree)


def test_encode_matches_reference():
    jmodel, tmodel, jparams, tparams = _pair()
    batch = _batch(tmodel.cfg, 2, 6)
    want = np.asarray(jax.jit(lambda p, f: jencode(
        p, jmodel.cfg, f, attn_impl="naive"))(jparams,
                                              jnp.asarray(batch["frames"])))
    got = encode(tparams, tmodel.cfg, torch.from_numpy(batch["frames"]))
    assert got.shape == (2, tmodel.cfg.encoder_seq, tmodel.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_prefill_logits_and_caches_match_reference():
    jmodel, tmodel, jparams, tparams = _pair(seed=3)
    batch = _batch(tmodel.cfg, 2, 10, seed=4)
    jlogits, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b,
                                                          cache_len=16))(
        jparams, _j(batch))
    tlogits, tcache = tmodel.prefill(tparams, _t(batch), cache_len=16)
    assert tlogits.shape == (2, 10, tmodel.cfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    cfg = tmodel.cfg
    assert tcache["self"]["k"].shape == (cfg.num_layers, 2, 16,
                                         cfg.num_kv_heads, cfg.head_dim)
    assert tcache["cross"]["v"].shape == (cfg.num_layers, 2,
                                          cfg.encoder_seq, cfg.num_kv_heads,
                                          cfg.head_dim)
    assert tcache["length"].dtype == torch.int32
    assert tcache["length"].tolist() == [10, 10]
    _assert_tree_close(tcache, _np(jcache), rtol=RTOL, atol=ATOL)


def test_two_decode_steps_match_reference():
    jmodel, tmodel, jparams, tparams = _pair(seed=5)
    batch = _batch(tmodel.cfg, 3, 10, seed=6)
    head = {"tokens": batch["tokens"][:, :8], "frames": batch["frames"]}
    _, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, cache_len=12))(
        jparams, _j(head))
    _, tcache = tmodel.prefill(tparams, _t(head), cache_len=12)
    jdecode = jax.jit(jmodel.decode_step)
    for i in (8, 9):
        tok = batch["tokens"][:, i:i + 1]
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok))
        tlogits, tcache = tmodel.decode_step(tparams, tcache,
                                             torch.from_numpy(tok))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=RTOL, atol=ATOL)
        _assert_tree_close(tcache, _np(jcache), rtol=RTOL, atol=ATOL)
    assert tcache["length"].tolist() == [10, 10, 10]


def test_make_cache_fills_cross_kv_as_reference():
    jmodel, tmodel, jparams, tparams = _pair(seed=7)
    batch = _batch(tmodel.cfg, 2, 4, seed=8)
    enc = jax.jit(lambda p, f: jencode(p, jmodel.cfg, f, attn_impl="naive"))(
        jparams, jnp.asarray(batch["frames"]))
    jcache = jmodel.make_cache(jparams, 2, 12, length=3, enc_states=enc)
    tcache = tmodel.make_cache(tparams, 2, 12, length=3,
                               enc_states=torch.from_numpy(np.asarray(enc)))
    _assert_tree_close(tcache, _np(jcache), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="enc_states"):
        tmodel.make_cache(tparams, 2, 12)


def test_forward_train_and_loss_match_reference():
    jmodel, tmodel, jparams, tparams = _pair(seed=9)
    batch = _batch(tmodel.cfg, 2, 12, seed=10)
    rng = np.random.default_rng(11)
    labels = rng.integers(0, tmodel.cfg.vocab_size, (2, 12)).astype(np.int32)
    labels[0, :3] = -1
    batch["labels"] = labels
    jlogits, _ = jax.jit(jmodel.forward_train)(jparams, _j(batch))
    got = tmodel.forward_train(tparams, _t(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), rtol=RTOL,
                               atol=ATOL)
    jloss, jmetrics = jax.jit(jmodel.loss)(jparams, _j(batch))
    tloss, tmetrics = tmodel.loss(tparams, _t(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    for k in ("nll", "accuracy", "moe_aux"):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                   rtol=RTOL, atol=ATOL)


def test_decode_matches_teacher_forced():
    """The port's own consistency: prefill and two decode steps give the
    logits of a full forward over the same tokens and frames."""
    _, tmodel, _, tparams = _pair(seed=12)
    B, S = 2, 16
    batch = _t(_batch(tmodel.cfg, B, S + 2, seed=13))
    full = tmodel.forward_train(tparams, batch)
    _, cache = tmodel.prefill(tparams, {"tokens": batch["tokens"][:, :S],
                                        "frames": batch["frames"]},
                              cache_len=S + 4)
    toks = batch["tokens"]
    lg1, cache = tmodel.decode_step(tparams, cache, toks[:, S:S + 1])
    lg2, cache = tmodel.decode_step(tparams, cache, toks[:, S + 1:S + 2])
    assert float((full[:, S] - lg1[:, 0]).abs().max()) < TF_TOL
    assert float((full[:, S + 1] - lg2[:, 0]).abs().max()) < TF_TOL
    assert cache["length"].tolist() == [S + 2] * B


def test_whisper_applies_no_rope(monkeypatch):
    """Every attention of whisper (encoder, self, cross; prefill and
    decode) runs without RoPE; with RoPE on, the encoder's output is off
    the reference's by more than the tolerance."""
    jmodel, tmodel, jparams, tparams = _pair(seed=14)
    batch = _t(_batch(tmodel.cfg, 2, 6, seed=15))
    calls = []
    real_rope = attn_mod.rope
    monkeypatch.setattr(attn_mod, "rope",
                        lambda *a, **kw: calls.append(1) or real_rope(*a,
                                                                      **kw))
    _, cache = tmodel.prefill(tparams, batch, cache_len=8)
    tmodel.decode_step(tparams, cache, batch["tokens"][:, :1])
    assert not calls
    want = np.asarray(jax.jit(lambda p, f: jencode(
        p, jmodel.cfg, f, attn_impl="naive"))(jparams,
                                              jnp.asarray(batch["frames"])))
    real_full = attn_mod.attention_full
    monkeypatch.setattr(
        "repro_torch.models.encdec.attention_full",
        lambda *a, **kw: real_full(*a[:3], torch.arange(a[2].shape[1])
                                   .expand(a[2].shape[:2]),
                                   **{**kw, "use_rope": True}))
    roped = encode(tparams, tmodel.cfg, batch["frames"])
    assert calls
    assert not np.allclose(roped.numpy(), want, rtol=RTOL, atol=ATOL)


def test_positions_past_the_table_raise():
    """The reference clamps a gather past ``dec_pos``; the port refuses a
    prompt or a cache the table cannot place, before reading."""
    _, tmodel, _, tparams = _pair(seed=16)
    rows = tparams["dec_pos"].shape[0]
    batch = _t(_batch(tmodel.cfg, 1, rows + 1, seed=17))
    with pytest.raises(ValueError, match="position table"):
        tmodel.forward_train(tparams, batch)
    short = {"tokens": batch["tokens"][:, :4], "frames": batch["frames"]}
    with pytest.raises(ValueError, match="position table"):
        tmodel.prefill(tparams, short, cache_len=rows + 1)
    _, cache = tmodel.prefill(tparams, short, cache_len=rows)
    cache["self"] = {k: torch.cat([v, v[:, :, :1]], dim=2)
                     for k, v in cache["self"].items()}
    with pytest.raises(ValueError, match="position table"):
        tmodel.decode_step(tparams, cache, batch["tokens"][:, 4:5])
    with pytest.raises(ValueError, match="position table"):
        serve_mod.serve(tmodel, tparams, short, rows - 3, 0.0,
                        torch.Generator().manual_seed(0))


# ------------------------------------------------------------------- CLIs
def test_serve_cli_runs_on_cpu_and_needs_a_card(monkeypatch):
    res = serve_mod.main(["--device", "cpu", "--smoke", "--arch", ARCH,
                          "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert res["tokens"].shape == (2, 3)
    assert res["cache"]["length"].tolist() == [10, 10]
    model, params, batch, _ = serve_mod.build(serve_mod.parse_args(
        ["--device", "cpu", "--smoke", "--arch", ARCH, "--batch", "2",
         "--prompt-len", "100", "--gen", "40"]))
    cfg = model.cfg
    assert batch["frames"].shape == (2, cfg.encoder_seq, cfg.d_model)
    assert batch["frames"].dtype == torch.float32
    # the table grows to prompt + gen + 1 rows, as the reference's server
    assert params["dec_pos"].shape[0] == 141 > cfg.decoder_max_position
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve_mod.build(serve_mod.parse_args(["--smoke", "--arch", ARCH]))


@pytest.mark.parametrize("arch,what", [("whisper-base", "frames")])
def test_train_cli_refuses_the_lm_round(arch, what, tmp_path):
    with pytest.raises(SystemExit, match=f"item 16.*{what}"):
        train_build(train_args(["--device", "cpu", "--smoke", "--arch", arch,
                                "--dataset", "lm", "--out", str(tmp_path)]))
