"""The FedTest round program (Algorithm 1), counterpart of
``repro/core/engine/program.py``. Step numbering as in DESIGN.md §2:

  1.  broadcast the global model to all N users
  2.  every user runs ``local_steps`` optimizer steps on its own shard
  2b. client failures: the fault model's survival mask is ANDed into the
      participation mask, so a dropped client is a non-sampled one
      (zero weight, frozen score, masked tester row)      (DESIGN.md §9)
  3.  malicious users swap in attacked models              (Sec. IV);
      a coalition's model attack composes in, its members joining the
      malicious set                                        (DESIGN.md §7)
  3b. non-participants' slots revert to the global model
  3c. compressed exchange: each client's update is encoded with error
      feedback, and every later step sees the decoded models
  4.  K testers evaluate all N models on their own data
  5.  lying testers (id < ``lying_testers``) report uniform draws
      instead                                              (Sec. V-C)
  5b. the coalition's members rewrite their tester rows   (DESIGN.md §7)
  6.  the server computes scores / weights (an aggregator that sets
      ``needs_server_eval`` gets ``ctx.server_eval``, every model's
      accuracy on the server's held-out set)
  7.  aggregation -> new global model, one of three ways:
      the score-weighted sum of the models (``weighted_aggregate``); a
      per-coordinate combine of the ``[N, D]`` update matrix
      (``robust_combine``); or, compressed, a weighted sum of the decoded
      updates (``dequant_aggregate`` for int8)

Randomness: where the reference derives every draw from
``round_keys(fold_in(key, round_idx))``, the port takes every draw of a
round from one :class:`RoundDraws`. Production draws it from a
``torch.Generator`` on the device (:meth:`RoundProgram.draw_round`); the
parity tests build it from the reference's key schedule, so both
packages run a round on the same random numbers. Steps 2b and 5 draw
only when their seam is on: a round without a fault or liars draws what
it drew before they were ported.

``round_idx`` is the host int of a single round or, in a chunk of rounds
(``FederatedTrainer.run_chunk``), the chunk's 0-d int64 counter on the
device: everything it reaches (the selectors, the ``targeted`` fault)
computes with it on the device, so a CUDA graph of the round reads it
there and nothing of the round is read to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.func import grad_and_value

from repro_torch import tracing
from repro_torch.config import FedConfig, TrainConfig
from repro_torch.core.cross_testing import make_eval_fn
from repro_torch.core.scoring import score_weights
from repro_torch.data.pipeline import sample_batch_indices
from repro_torch.optim import make_optimizer
from repro_torch.strategies.base import (
    AttackContext, RoundContext, uses_combine)
from repro_torch.utils import flat_update_dim, tree_add_vector, tree_leaves


class RoundDraws(NamedTuple):
    """Every random number one round consumes."""

    # [N, steps, batch] int64 row indices; the population tier's are the
    # cohort's rows of the same draw, [C, steps, batch]
    batch_idx: torch.Tensor
    tester_ids: torch.Tensor         # [K] int32
    # [N] f32, all ones at participation 1; the population tier's is the
    # mask its cohort honours (cohort_from_mask's eff_mask)
    part_mask: torch.Tensor
    # malicious client -> one standard normal per param leaf (tree_leaves
    # order); None when the attack draws no noise. The population tier's
    # is a source its attack draws from by slot (population.KeyedNoise,
    # or a RecordedNoise replaying given draws)
    noise: Optional[Any] = None
    # [N, eval_batch] int64 tester eval rows under eval resampling
    # (cross_testing.eval_batch_indices); None keeps the fixed prefix
    eval_idx: Optional[torch.Tensor] = None
    # [N] the fault model's draws (Fault.draw); None without a fault or
    # for a fault that draws nothing
    fault_draws: Optional[torch.Tensor] = None
    # [K, N] uniform reports of the lying testers; None without liars
    lies: Optional[torch.Tensor] = None
    # the population tier's cohort (population.CohortPlan: its slots and
    # their clients on the device, derived from part_mask); None on the
    # dense engine
    cohort: Optional[Any] = None


def participation_mask(gen: torch.Generator, num_users: int,
                       participation: float) -> torch.Tensor:
    """Per-round Bernoulli client-sampling mask ``[N]`` (1 = sampled),
    ``uniform < p`` as ``jax.random.bernoulli`` draws it; everyone when
    nobody was sampled, so a round is always well defined."""
    u = torch.rand((num_users,), generator=gen, device=gen.device)
    bern = (u < participation).float()
    return torch.where(bern.any(), bern, torch.ones_like(bern))


def compose_fault_mask(part_mask: torch.Tensor, alive: torch.Tensor
                       ) -> torch.Tensor:
    """AND the fault survival mask into the participation mask (step 2b).
    If every selected client dropped, the faults are ignored for the
    round, so a round is always well defined."""
    combined = part_mask * alive
    return torch.where(combined.sum() > 0, combined, part_mask)


def renormalize_over_subset(weights: torch.Tensor, part_mask: torch.Tensor
                            ) -> torch.Tensor:
    """Zero non-participants and renormalise the simplex over the subset
    (uniform over it if the subset got zero total weight)."""
    w = weights * part_mask
    total = w.sum()
    return torch.where(total > 1e-12, w / torch.clamp(total, min=1e-12),
                       part_mask / part_mask.sum())


def aggregator_defaults(fed: FedConfig) -> Dict[str, Any]:
    """Engine-derived default kwargs offered to aggregator constructors
    (each takes only the ones its ``__init__`` accepts)."""
    return dict(score_power=fed.score_power,
                score_decay=fed.score_decay,
                power_warmup_rounds=fed.power_warmup_rounds,
                num_byzantine=fed.num_malicious)


def resolve_strategies(fed: FedConfig):
    """Name -> object resolution for (aggregator, attack, selector)."""
    from repro_torch.strategies import AGGREGATORS, ATTACKS, SELECTORS
    agg = AGGREGATORS.build(fed.aggregator, fed.strategy_kwargs("aggregator"),
                            aggregator_defaults(fed))
    atk = ATTACKS.build(fed.attack, fed.strategy_kwargs("attack"),
                        dict(num_malicious=fed.num_malicious,
                             scale=fed.attack_scale))
    # coverage derives its per-cycle shuffle from the run seed
    sel = SELECTORS.build(fed.selector, fed.strategy_kwargs("selector"),
                          dict(seed=fed.seed))
    return agg, atk, sel


def resolve_fault(fed: FedConfig):
    """Name -> object resolution for ``fed.fault``; ``rate`` defaults to
    ``fed.fault_rate`` (dropped where the model does not take it)."""
    from repro_torch.strategies import FAULTS
    return FAULTS.build(fed.fault, fed.strategy_kwargs("fault"),
                        dict(rate=fed.fault_rate))


def resolve_coalition(fed: FedConfig):
    """Name -> object resolution for ``fed.coalition``; ``size`` defaults
    to ``fed.coalition_size`` and the model attack's total ``scale`` to
    ``fed.attack_scale`` (each dropped where not taken)."""
    from repro_torch.strategies import COALITIONS
    return COALITIONS.build(fed.coalition, fed.strategy_kwargs("coalition"),
                            dict(size=fed.coalition_size,
                                 scale=fed.attack_scale))


def resolve_compressor(fed: FedConfig, model):
    """Name -> object resolution for ``fed.compressor``, with the flat
    update width ``dim`` injected."""
    from repro_torch.strategies import COMPRESSORS
    return COMPRESSORS.build(fed.compressor,
                             fed.strategy_kwargs("compressor"),
                             dict(dim=flat_update_dim(model)))


def training_route_model(model):
    """The model local training differentiates: an LM's attention and
    scan through their differentiable twins (``blockwise_attention``,
    ``ssd_chunked``), the reference's ``attention_xla`` / ``_ssd_xla``;
    the kernel ops are forward-only and raise under a gradient. cnn/mlp
    unchanged. Cross-testing, the server's eval and the global accuracy
    take the caller's model, whose LM forward runs the kernels."""
    if model.cfg.family in ("cnn", "mlp"):
        return model
    return dataclasses.replace(model, differentiable=True)


def init_comp_state(fed: FedConfig, model, device=None):
    """Initial ``[N, D]`` error-feedback buffer; ``None`` when the
    exchange is uncompressed."""
    if fed.compressor == "identity":
        return None
    return resolve_compressor(fed, model).init_state(fed.num_users, device)


class RoundProgram:
    """Steps 1-7 of the FedTest round, with every strategy, the optimizer
    and the shared eval function resolved once at construction. An LM
    trains through :func:`training_route_model` and evaluates through the
    kernel ops (``model`` as given)."""

    def __init__(self, model, fed: FedConfig, train_cfg: TrainConfig):
        self.model = model
        self.train_model = training_route_model(model)
        self.fed = fed
        self.train_cfg = train_cfg
        self.opt = make_optimizer(train_cfg)
        # one eval fn, shared by cross-testing, the server's eval and the
        # global accuracy
        self.eval_fn = make_eval_fn(model)
        self.aggregator, self.attack, self.selector = resolve_strategies(fed)
        # a coalition's model attack composes into step 3 (the malicious
        # set becomes the union), its report transform runs as step 5b
        self.coalition = resolve_coalition(fed)
        self.coalition_active = self.coalition.active
        if self.coalition_active:
            self.attack = self.coalition.compose(self.attack, fed.num_users)
        self.fault = resolve_fault(fed)
        self.use_faults = fed.fault != "none"
        self.malicious_idx = self.attack.malicious_indices(fed.num_users)
        self.use_participation = fed.participation < 1.0
        # a non-None combine hook routes step 7 through the per-coordinate
        # combine; the update matrix is built when either path reads it
        self.uses_combine = uses_combine(self.aggregator)
        self.needs_updates = (self.aggregator.needs_updates
                              or self.uses_combine)
        # 'identity' switches the compression seam off: the default round
        # stays the uncompressed one (g + (m - g) in f32 is not bitwise m)
        self.use_compression = fed.compressor != "identity"
        self.compressor = (resolve_compressor(fed, model)
                           if self.use_compression else None)

    # ---------------------------------------------------------- local phase
    def batchify(self, bx, by) -> Dict[str, torch.Tensor]:
        """One step's model batch from its rows and labels."""
        if self.model.cfg.family in ("cnn", "mlp"):
            return {"images": bx, "labels": by}
        return {"tokens": bx, "labels": by}

    def local_train(self, params, bx, by):
        """One client's local phase: ``local_steps`` optimizer steps on
        ``bx [steps, batch, ...]``, differentiating ``train_model``. The
        backend runs it for every client at once under
        ``torch.func.vmap``; each step runs in the span ``train.step``, its
        gradient in ``train.step.grad`` and its update in
        ``train.step.update``, opened once for all clients."""
        opt_state = self.opt.init(params)
        step_grad = grad_and_value(self.train_model.loss, has_aux=True)
        losses = []
        for s in range(bx.shape[0]):
            with tracing.span("train.step"):
                with tracing.span("train.step.grad"):
                    grads, (loss, _) = step_grad(
                        params, self.batchify(bx[s], by[s]))
                with tracing.span("train.step.update"):
                    params, opt_state = self.opt.update(grads, opt_state,
                                                        params)
            losses.append(loss)
        return params, torch.stack(losses).mean()

    # ------------------------------------------------------- round plumbing
    def draw_selection(self, gen: torch.Generator, round_idx, scores=None):
        """The round's first draws: the ``[K]`` tester ids, then the
        ``[N]`` participation mask (all ones at participation 1, drawing
        nothing)."""
        fed = self.fed
        tester_ids = self.selector.select(gen, fed.num_users,
                                          fed.num_testers, round_idx,
                                          scores=scores)
        if self.use_participation:
            part_mask = participation_mask(gen, fed.num_users,
                                           fed.participation)
        else:
            part_mask = torch.ones((fed.num_users,), dtype=torch.float32,
                                   device=gen.device)
        return tester_ids, part_mask

    def draw_seams(self, gen: torch.Generator):
        """The round's last draws, ``(fault_draws, lies)``: the seams of
        steps 2b and 5 draw after everything else, and only when they
        are on."""
        fed = self.fed
        fault_draws = (self.fault.draw(gen, fed.num_users)
                       if self.use_faults else None)
        lies = (torch.rand((fed.num_testers, fed.num_users), generator=gen,
                           device=gen.device)
                if fed.lying_testers else None)
        return fault_draws, lies

    def draw_round(self, gen: torch.Generator, counts: torch.Tensor,
                   round_idx, global_params, scores=None) -> RoundDraws:
        """The round's random numbers, drawn from ``gen`` on its device.
        ``scores`` are the ``[N]`` scores entering the round. The
        population tier draws the same stream up to the noise
        (``PopulationTrainer.draw``)."""
        tester_ids, part_mask = self.draw_selection(gen, round_idx, scores)
        batch_idx = sample_batch_indices(gen, counts, self.fed.local_steps,
                                         self.train_cfg.batch_size)
        noise = None
        if self.attack.needs_noise:
            noise = {c: [torch.randn(leaf.shape, generator=gen,
                                     device=gen.device)
                         for leaf in tree_leaves(global_params)]
                     for c in self.malicious_idx}
        fault_draws, lies = self.draw_seams(gen)
        return RoundDraws(batch_idx, tester_ids, part_mask, noise,
                          fault_draws=fault_draws, lies=lies)

    # ------------------------------------------------------------ the round
    def run(self, backend, global_params, scores, *, bx, by, tx, ty,
            draws: RoundDraws, round_idx, counts, server_data=None,
            comp_state=None):
        """One FedTest round on ``backend``; returns ``(new_global,
        new_scores, new_comp_state, metrics)``. ``bx, by`` are the round's
        training batches ``[N, steps, batch, ...]`` and ``tx, ty`` every
        client's local test shard ``[N, eval_batch, ...]``.
        ``server_data`` is the server's ``(sx, sy)`` eval set, which an
        aggregator that ``needs_server_eval`` requires. ``comp_state`` is
        the ``[N, D]`` error-feedback buffer of a compressed exchange,
        ``None`` (and ``new_comp_state`` too) otherwise. Steps 1-2, 3, 3b,
        3c, 4, 6 and 7 run in the spans ``train``, ``attack``, ``mask``,
        ``compress``, ``cross_test``, ``scores`` and ``aggregate``
        (:mod:`repro_torch.tracing`)."""
        fed = self.fed
        pmask = draws.part_mask if self.use_participation else None
        tester_ids = draws.tester_ids

        # 2b. client failures: a dropped client is a non-sampled one from
        # here on (zero weight, frozen score, masked tester row)
        dropped_fraction = torch.zeros((), device=draws.part_mask.device)
        if self.use_faults:
            part = draws.part_mask
            alive = self.fault.mask(draws.fault_draws, fed.num_users,
                                    round_idx, device=part.device)
            pmask = compose_fault_mask(part, alive)
            dropped_fraction = ((part.sum() - pmask.sum())
                                / torch.clamp(part.sum(), min=1.0))

        # 1-2. broadcast + local training
        with tracing.span("train"):
            models, local_loss = backend.train(self.local_train,
                                               global_params, bx, by)

        # 3. adversaries act; the AttackContext exposes the scores and
        # weights entering the round
        with tracing.span("attack"):
            actx = AttackContext(scores=scores.scores,
                                 weights=score_weights(scores),
                                 round_idx=round_idx)
            models = backend.apply_attack(self.attack, draws.noise, models,
                                          global_params, actx)

        # 3b. non-participants transmit nothing: their slot holds the
        # stale global copy
        if pmask is not None:
            with tracing.span("mask"):
                models = backend.mask_models(models, global_params, pmask)

        # 3c. compressed exchange: each participating client encodes its
        # flat update, with error feedback banked in comp_state, and every
        # later step sees only the decoded models. A masked client
        # transmits nothing: its buffer stays and its decoded update is 0.
        new_comp_state = comp_state
        comp_payloads = comp_decoded = None
        if self.use_compression:
            with tracing.span("compress"):
                models, comp_payloads, comp_decoded, new_comp_state = (
                    backend.compress_exchange(self.compressor, models,
                                              global_params, comp_state,
                                              pmask))

        # 4. the round's testers measure accuracies on their own data
        with tracing.span("cross_test"):
            acc = backend.cross_test(self.eval_fn, models, tx, ty,
                                     tester_ids)

        # 5. lying testers (Sec. V-C): a tester with id < lying_testers
        # reports uniform draws whenever it is selected
        if fed.lying_testers:
            liar_rows = (tester_ids < fed.lying_testers)[:, None]
            acc = torch.where(liar_rows, draws.lies, acc)

        # 5b. the coalition's members rewrite their tester rows (mutual
        # boost and targeted defamation by the scores entering the round)
        if self.coalition_active:
            acc = self.coalition.transform_reports(None, acc, tester_ids,
                                                   actx)

        # 6. scores, then weights, via the aggregation strategy; the
        # [N, D] update matrix is built at most once a round, for
        # ctx.updates and the combine path alike
        with tracing.span("scores"):
            server_eval = None
            if self.aggregator.needs_server_eval:
                if server_data is None:
                    raise ValueError(
                        f"aggregator {self.aggregator.name!r} needs a "
                        "server-side eval set; pass server_data=(sx, sy)")
                sx, sy = server_data
                server_eval = backend.server_eval(self.eval_fn, models, sx,
                                                  sy)
            updates = (backend.updates(models, global_params)
                       if self.needs_updates else None)
            ctx = RoundContext(acc_matrix=acc, tester_ids=tester_ids,
                               scores=scores, counts=counts,
                               round_idx=round_idx, updates=updates,
                               server_eval=server_eval, participation=pmask,
                               report_mask=(pmask[tester_ids.long()]
                                            if pmask is not None else None))
            new_scores = self.aggregator.update_scores(ctx)
            ctx = ctx._replace(scores=new_scores)
            weights = self.aggregator.weights(ctx)
            if pmask is not None:
                weights = renormalize_over_subset(weights, pmask)

        # 7. aggregation -> new global model: the per-coordinate combine
        # of the update matrix; compressed, the weighted sum of the
        # decoded updates taken from the wire representation; else the
        # weighted sum of the models
        with tracing.span("aggregate"):
            if self.uses_combine:
                new_global = tree_add_vector(
                    global_params, self.aggregator.combine(ctx, updates))
            elif self.use_compression:
                new_global = tree_add_vector(
                    global_params,
                    backend.compressed_sum(self.compressor, comp_payloads,
                                           comp_decoded, weights))
            else:
                new_global = backend.weighted_sum(models, weights,
                                                  global_params)

        # the malicious set comes from the attack strategy, so the metric
        # stays right for any placement (an empty set reads 0)
        mal_w = (weights * self.attack.malicious_mask(
            fed.num_users, weights.device)).sum()
        metrics = {
            "local_loss": ((local_loss * pmask).sum()
                           / torch.clamp(pmask.sum(), min=1)
                           if pmask is not None else local_loss.mean()),
            "acc_matrix_mean": acc.mean(),
            "weights": weights,
            "malicious_weight": mal_w,
            "scores": new_scores.scores,
            "participation_rate": (pmask.mean() if pmask is not None
                                   else torch.ones((), device=acc.device)),
            # the share of the selected clients lost to faults
            "dropped_fraction": dropped_fraction,
        }
        return new_global, new_scores, new_comp_state, metrics
