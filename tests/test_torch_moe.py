"""The port's moe and hybrid families against the reference.

On the CPU in f32, at ``reduce_for_smoke`` widths (2 layers, d_model 256,
4 experts top-2; Jamba's smoke stack is a mamba slot with a SwiGLU FFN
and an attention slot with a MoE): params made by the JAX package go
through ``params_from_reference``, the same numpy inputs go through both
packages (the reference with ``attn_impl="naive"`` and
``ssm_impl="naive"``, its plain oracles; the port on the CPU, where the
kernel ops run their plain versions).

* ``moe_apply`` on both routes, outputs and ``aux``, at rtol 1e-4, atol
  1e-5, a capacity case that drops tokens among them; ``vmap`` of each
  route equal to a loop over the mapped dimension;
* for ``granite-moe-1b-a400m``, ``qwen3-moe-30b-a3b`` and
  ``jamba-1.5-large-398b``: the configs field for field at full and
  smoke widths, the exact parameter counts, forward, prefill and two
  decode steps, and ``Model.loss`` with ``moe_aux``, at rtol 1e-4, atol
  1e-5 (XLA and PyTorch sum in other orders); teacher forcing with a
  dropless prefill at 3e-4, as ``tests/test_decode_consistency.py``
  holds the reference;
* the period stack (Jamba: attention at slot 4 of 8, MoE on the odd
  slots), the f32 router, the two dense configs ``qwen2-72b`` and
  ``qwen1.5-110b``, and the serve and train CLIs at ``--smoke``.

Inputs are continuous random draws, so no two router probabilities tie.
Torch runs on one thread here, as in ``tests/test_torch_lm_round.py``:
these small ops lose more to thread hand-offs than they gain when the
suite's other workers share the cores.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduce_for_smoke as jreduce  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models.moe import (  # noqa: E402
    _capacity, moe_apply as jmoe_apply, moe_init as jmoe_init)
from repro_torch.config import ModelConfig, reduce_for_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core.engine import training_route_model  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch.train import build, parse_args  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.decoder import _period, decoder_specs  # noqa: E402
from repro_torch.models.moe import moe_apply, moe_init  # noqa: E402
from repro_torch.models.params import count_params_analytic  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
TF_TOL = 3e-4
ARCHS = ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b",
         "jamba-1.5-large-398b")
# (total, active) params at full width, the reference's count_params_analytic
PARAMS = {
    "granite-moe-1b-a400m": (1_334_628_352, 428_658_688),
    "qwen3-moe-30b-a3b": (30_532_122_624, 3_353_032_704),
    "jamba-1.5-large-398b": (397_596_263_520, 93_190_456_416),
    "qwen2-72b": (72_706_203_648, 72_706_203_648),
    "qwen1.5-110b": (111_209_914_368, 111_209_914_368),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch, **kw):
    """Both packages' smoke configs of ``arch`` in f32."""
    kw = dict(dtype="float32", **kw)
    return (jreduce(jget_config(arch)).replace(**kw),
            reduce_for_smoke(get_config(arch)).replace(**kw))


def _assert_tree_close(got, want, **tol):
    flat_want = jax.tree_util.tree_leaves(want)
    flat_got = tree_leaves(got)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


# --------------------------------------------------------------- moe_apply
def _moe_pair(arch="granite-moe-1b-a400m", seed=0, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jp = jmoe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _dropped(jp, cfg, x, group):
    """Top-k choices past their expert's capacity in the reference's
    grouping of ``x`` (numpy, from its router)."""
    T = x.shape[0] * x.shape[1]
    g = min(group, T)
    while T % g:
        g -= 1
    C = _capacity(g, cfg.num_experts_per_tok, cfg.num_experts)
    probs = jax.nn.softmax(x.reshape(T // g, g, -1) @ np.asarray(
        jp["router"]), -1)
    _, idx = jax.lax.top_k(probs, cfg.num_experts_per_tok)
    idx = np.asarray(idx).reshape(T // g, -1)
    return sum(int(np.maximum(np.bincount(row, minlength=cfg.num_experts)
                              - C, 0).sum()) for row in idx)


# (experts, top-k, group size, dropless): the smoke's 4 experts top-2 on
# each route; a group of 8 tokens, whose capacity of 5 a expert drops
# choices; top-1 (the aux's k == 1 form); 8 experts top-3
MOE_CASES = [(4, 2, 0, True), (4, 2, 0, False), (4, 2, 8, False),
             (4, 1, 0, False), (4, 1, 0, True), (8, 3, 16, False),
             (8, 3, 0, True)]


@pytest.mark.parametrize("experts,top_k,group,dropless", MOE_CASES)
def test_moe_apply_matches_reference(experts, top_k, group, dropless):
    jcfg, tcfg, jp, tp = _moe_pair(num_experts=experts,
                                   num_experts_per_tok=top_k)
    x = np.random.default_rng(experts + top_k).standard_normal(
        (3, 16, jcfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(lambda p, x: jmoe_apply(
        p, jcfg, x, group_size=group, dropless=dropless))(jp, jnp.asarray(x))
    ty, taux = moe_apply(tp, tcfg, torch.from_numpy(x), group_size=group,
                         dropless=dropless)
    assert ty.shape == x.shape and taux.shape == ()
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL,
                               atol=ATOL)
    if group == 8:
        assert _dropped(jp, jcfg, x, group) > 0


def test_capacity_route_drops_to_the_residual():
    """With a group of 8 tokens the capacity route drops choices, so it
    differs from the dropless route on some tokens; a dropped choice adds
    nothing (a token with both choices dropped gets y = 0)."""
    jcfg, tcfg, jp, tp = _moe_pair(seed=3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32))
    capped, _ = moe_apply(tp, tcfg, x, group_size=8)
    full, _ = moe_apply(tp, tcfg, x, dropless=True)
    assert _dropped(jp, jcfg, x.numpy(), 8) > 0
    differ = (capped - full).abs().amax(-1) > 1e-5
    assert 0 < int(differ.sum()) < differ.numel()


@pytest.mark.parametrize("group,dropless", [(0, True), (0, False),
                                            (8, False)])
def test_moe_vmap_equals_a_loop(group, dropless):
    """``vmap`` over a leading dimension of x and of the params (as the
    round's local training and cross-test map over clients) equals a
    loop: each instance groups its own tokens."""
    _, tcfg, _, _ = _moe_pair()
    tps = [_moe_pair(seed=s)[3] for s in range(3)]
    stacked = tree_map(lambda *a: torch.stack(a), *tps)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 2, 16, tcfg.d_model)).astype(np.float32))
    got_y, got_aux = torch.func.vmap(lambda p, xb: moe_apply(
        p, tcfg, xb, group_size=group, dropless=dropless))(stacked, x)
    for i, p in enumerate(tps):
        y, aux = moe_apply(p, tcfg, x[i], group_size=group,
                           dropless=dropless)
        np.testing.assert_allclose(got_y[i].numpy(), y.numpy(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(float(got_aux[i]), float(aux), rtol=RTOL,
                                   atol=ATOL)


def test_moe_init_draws_each_bank_a_layer_at_a_time():
    """The stacked init: the router f32, each bank in the model's dtype
    and stacked on the lead axis, each layer's slice a fan-in truncated
    normal of its own (its std near fan_in ** -0.5 times the truncated
    normal's 0.88), the layers' slices distinct."""
    _, tcfg = _cfgs("granite-moe-1b-a400m")
    p = moe_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16,
                 lead=(3,))
    E, D, F = tcfg.num_experts, tcfg.d_model, tcfg.d_ff
    assert p["router"].dtype == torch.float32
    assert tuple(p["router"].shape) == (3, D, E)
    for name, shape, fan_in in (("w_gate", (E, D, F), D),
                                ("w_up", (E, D, F), D),
                                ("w_down", (E, F, D), F)):
        bank = p[name]
        assert bank.dtype == torch.bfloat16
        assert tuple(bank.shape) == (3,) + shape
        for layer in range(3):
            std = float(bank[layer].float().std())
            assert abs(std * fan_in ** 0.5 - 0.88) < 0.03, (name, std)
            assert float(bank[layer].float().abs().max()) <= 2 * fan_in ** -0.5 + 1e-2
        assert not torch.equal(bank[0], bank[1])


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS + ("qwen2-72b", "qwen1.5-110b"))
def test_configs_match_reference_field_for_field(arch):
    for port, ref in ((get_config(arch), jget_config(arch)),
                      (reduce_for_smoke(get_config(arch)),
                       jreduce(jget_config(arch)))):
        for f in dataclasses.fields(ModelConfig):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert port.has_moe == ref.has_moe
        for layer in range(port.num_layers):
            assert port.uses_attention(layer) == ref.uses_attention(layer)
            assert port.uses_moe(layer) == ref.uses_moe(layer)


@pytest.mark.parametrize("arch", sorted(PARAMS))
def test_param_counts_are_the_references(arch, monkeypatch):
    """The exact counts at full width, from the specs' shapes: no tensor
    is made (398 B params would not fit this host)."""
    def refuse(*a, **kw):
        raise AssertionError("count_params_analytic allocated a tensor")
    for name in ("empty", "zeros", "ones", "full"):
        monkeypatch.setattr(torch, name, refuse)
    total, active = PARAMS[arch]
    cfg = get_config(arch)
    assert count_params_analytic(cfg) == cfg.param_count() == total
    assert count_params_analytic(cfg, active_only=True) == active
    assert cfg.active_param_count() == active
    assert build_model(cfg).param_count() == total


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_param_counts_match_the_reference_init(arch):
    jcfg, tcfg = _cfgs(arch)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    params = build_model(tcfg).init(torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in tree_leaves(params)) == tcfg.param_count()


def test_jamba_period_stack():
    """Jamba: a period of 8 (attention at slot 4, MoE on the odd slots),
    nine periods a 72-layer stack, each slot's leaves stacked [9, ...];
    the router f32, the experts in the model's dtype. The moe family is
    one slot a layer."""
    cfg = get_config("jamba-1.5-large-398b")
    assert _period(cfg) == 8
    specs = decoder_specs(cfg, torch.bfloat16)
    assert sorted(specs["layers"]) == [f"slot_{s}" for s in range(8)]
    for s in range(8):
        slot = specs["layers"][f"slot_{s}"]
        mixer = "attn" if s == 4 else "mamba"
        ffn = "moe" if s % 2 else "ffn"
        assert sorted(slot) == sorted(["norm1", mixer, "norm2", ffn]), s
        assert slot["norm1"]["scale"][0] == (9, cfg.d_model)
    moe = specs["layers"]["slot_1"]["moe"]
    assert moe["router"] == ((9, 8192, 16), torch.float32)
    assert moe["w_down"] == ((9, 16, 24576, 8192), torch.bfloat16)
    smoke = reduce_for_smoke(cfg)
    assert _period(smoke) == 2
    slots = decoder_specs(smoke, torch.float32)["layers"]
    assert sorted(slots["slot_0"]) == ["ffn", "mamba", "norm1", "norm2"]
    assert sorted(slots["slot_1"]) == ["attn", "moe", "norm1", "norm2"]
    granite = decoder_specs(get_config("granite-moe-1b-a400m"),
                            torch.bfloat16)
    assert sorted(granite["layers"]) == ["slot_0"]
    assert granite["layers"]["slot_0"]["moe"]["w_gate"][0] == (
        24, 32, 1024, 512)


# ------------------------------------------------------------------ models
@functools.lru_cache(maxsize=None)
def _jmodel(arch, dtype="float32", moe_dropless=False):
    cfg = jreduce(jget_config(arch)).replace(dtype=dtype)
    model = jbuild_model(cfg, attn_impl="naive", ssm_impl="naive",
                         moe_dropless=moe_dropless)
    return model, jax.jit(model.init)


def _pair(arch, seed=0, moe_dropless=False):
    jmodel, jinit = _jmodel(arch, moe_dropless=moe_dropless)
    jparams = jinit(jax.random.PRNGKey(seed))
    cfg = reduce_for_smoke(get_config(arch)).replace(dtype="float32")
    tmodel = build_model(cfg, moe_dropless=moe_dropless)
    tparams = params_from_reference(_np(jparams), "cpu", model=tmodel)
    return jmodel, tmodel, jparams, tparams


def _tokens(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch):
    jmodel, tmodel, jparams, tparams = _pair(arch)
    toks = _tokens(tmodel.cfg, 2, 12)
    want = np.asarray(jax.jit(jmodel.forward_train)(
        jparams, {"tokens": jnp.asarray(toks)})[0])
    got = tmodel.forward_train(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape == (2, 12, tmodel.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

    jlogits, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, cache_len=16))(
        jparams, {"tokens": jnp.asarray(toks)})
    tlogits, tcache = tmodel.prefill(tparams,
                                     {"tokens": torch.from_numpy(toks)},
                                     cache_len=16)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    assert tcache["length"].dtype == torch.int32
    assert sorted(tcache["layers"]) == sorted(jcache["layers"])
    _assert_tree_close(tcache, _np(jcache), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_decode_steps_match_reference(arch):
    jmodel, tmodel, jparams, tparams = _pair(arch, seed=2)
    toks = _tokens(tmodel.cfg, 3, 10, seed=3)
    jprefill = jax.jit(lambda p, b: jmodel.prefill(p, b, cache_len=12))
    jdecode = jax.jit(jmodel.decode_step)
    _, jcache = jprefill(jparams, {"tokens": jnp.asarray(toks[:, :8])})
    _, tcache = tmodel.prefill(tparams,
                               {"tokens": torch.from_numpy(toks[:, :8])},
                               cache_len=12)
    for i in (8, 9):
        jlogits, jcache = jdecode(jparams, jcache,
                                  jnp.asarray(toks[:, i:i + 1]))
        tlogits, tcache = tmodel.decode_step(
            tparams, tcache, torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=RTOL, atol=ATOL)
        _assert_tree_close(tcache, _np(jcache), rtol=RTOL, atol=ATOL)
    assert tcache["length"].tolist() == [10, 10, 10]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forced(arch):
    """The port's own consistency, as tests/test_decode_consistency.py
    holds the reference's: with a dropless prefill, prefill + two decode
    steps give the logits of a full dropless forward over the same
    tokens."""
    _, tmodel, _, tparams = _pair(arch, seed=4, moe_dropless=True)
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(tmodel.cfg, B, S + 2, seed=5))
    full = tmodel.forward_train(tparams, {"tokens": toks})
    _, cache = tmodel.prefill(tparams, {"tokens": toks[:, :S]},
                              cache_len=S + 4)
    lg1, cache = tmodel.decode_step(tparams, cache, toks[:, S:S + 1])
    lg2, cache = tmodel.decode_step(tparams, cache, toks[:, S + 1:S + 2])
    assert float((full[:, S] - lg1[:, 0]).abs().max()) < TF_TOL
    assert float((full[:, S + 1] - lg2[:, 0]).abs().max()) < TF_TOL
    assert cache["length"].tolist() == [S + 2] * B


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("moe_dropless", [False, True])
def test_loss_and_moe_aux_match_reference(arch, moe_dropless):
    """``Model.loss``: nll + router_aux_coef * moe_aux, with the summed
    aux among the metrics, on each route."""
    jmodel, tmodel, jparams, tparams = _pair(arch, seed=6,
                                             moe_dropless=moe_dropless)
    toks = _tokens(tmodel.cfg, 2, 12, seed=7)
    labels = _tokens(tmodel.cfg, 2, 12, seed=8)
    labels[0, :3] = -1
    jloss, jm = jax.jit(jmodel.loss)(jparams, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tloss, tm = tmodel.loss(tparams, {"tokens": torch.from_numpy(toks),
                                      "labels": torch.from_numpy(labels)})
    assert float(jm["moe_aux"]) > 0
    assert sorted(tm) == sorted(jm)
    for got, want in ((tloss, jloss), (tm["nll"], jm["nll"]),
                      (tm["moe_aux"], jm["moe_aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                   atol=ATOL)
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    np.testing.assert_allclose(
        float(tloss), float(tm["nll"]) + tmodel.cfg.router_aux_coef
        * float(tm["moe_aux"]), rtol=1e-6)


def test_model_group_size_routes_as_the_reference():
    """``Model(moe_group_size=8)``: the forward groups 8 tokens, whose
    capacity drops choices, as the reference's model with the same field
    does."""
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m")
    jmodel = jbuild_model(jcfg, attn_impl="naive", moe_group_size=8)
    tmodel = build_model(tcfg, moe_group_size=8)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(12))
    tparams = params_from_reference(_np(jparams), "cpu", model=tmodel)
    toks = _tokens(tcfg, 2, 16, seed=13)
    want = np.asarray(jax.jit(jmodel.forward_train)(
        jparams, {"tokens": jnp.asarray(toks)})[0])
    got = tmodel.forward_train(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    default = build_model(tcfg).forward_train(
        tparams, {"tokens": torch.from_numpy(toks)})
    assert float((default - got).abs().max()) > 1e-3


def test_loss_gradient_reaches_the_router():
    """Training through the aux loss: the gradient of ``Model.loss`` on
    the capacity route (through the training route's twins) reaches every
    router and expert bank, finite."""
    _, tmodel, _, tparams = _pair("granite-moe-1b-a400m", seed=9)
    tmodel = training_route_model(tmodel)
    toks = torch.from_numpy(_tokens(tmodel.cfg, 2, 12, seed=10))
    grads = torch.func.grad(lambda p: tmodel.loss(
        p, {"tokens": toks, "labels": toks})[0])(tparams)
    moe = grads["layers"]["slot_0"]["moe"]
    for name in ("router", "w_gate", "w_up", "w_down"):
        g = moe[name]
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_reference_tree_keeps_f32_router_and_scales(arch):
    jmodel, jinit = _jmodel(arch, dtype="bfloat16")
    jparams = _np(jinit(jax.random.PRNGKey(11)))
    tmodel = build_model(reduce_for_smoke(get_config(arch)))
    assert tmodel.dtype == torch.bfloat16
    tparams = params_from_reference(jparams, "cpu", model=tmodel)
    want_dtypes = jax.tree_util.tree_map(lambda a: str(a.dtype), jparams)
    got_dtypes = tree_map(lambda t: str(t.dtype).replace("torch.", ""),
                          tparams)
    assert got_dtypes == want_dtypes
    routers = [s["moe"]["router"] for s in tparams["layers"].values()
               if "moe" in s]
    assert routers and all(r.dtype == torch.float32 for r in routers)
    _assert_tree_close(tparams, jparams, rtol=0, atol=0)


# -------------------------------------------------------------------- CLIs
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_cpu(arch):
    res = serve_mod.main(["--device", "cpu", "--smoke", "--arch", arch,
                          "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert res["tokens"].shape == (2, 3)
    assert res["cache"]["length"].tolist() == [10, 10]


def test_serve_build_takes_a_cut_config():
    """``build``'s overrides replace fields of the arch's config (the
    card's reduced Jamba period cuts depth and widths) before
    ``--smoke``."""
    model, params, batch, _ = serve_mod.build(
        serve_mod.parse_args(["--device", "cpu", "--smoke", "--arch",
                              "granite-moe-1b-a400m", "--batch", "1",
                              "--prompt-len", "4"]),
        num_layers=1, vocab_size=64)
    assert (model.cfg.num_layers, model.cfg.vocab_size) == (1, 64)
    assert tuple(params["embed"].shape) == (64, model.cfg.d_model)
    tokens = batch["tokens"]
    assert tuple(tokens.shape) == (1, 4) and int(tokens.max()) < 64


def test_train_cli_runs_a_moe_lm_round(tmp_path):
    trainer, data, cfg = build(parse_args(
        ["--device", "cpu", "--smoke", "--arch", "granite-moe-1b-a400m",
         "--dataset", "lm", "--users", "4", "--testers", "2",
         "--malicious", "1", "--local-steps", "2", "--batch", "8",
         "--optimizer", "adamw", "--lr", "2e-3", "--rounds", "1",
         "--out", str(tmp_path)]))
    assert cfg.family == "moe" and not trainer.program.model.moe_dropless
    state, metrics = trainer.run_round(trainer.init(), data)
    assert abs(float(metrics["weights"].sum()) - 1.0) < 1e-6
    assert np.isfinite(float(metrics["local_loss"]))
    router = state.global_params["layers"]["slot_0"]["moe"]["router"]
    assert router.dtype == torch.float32
