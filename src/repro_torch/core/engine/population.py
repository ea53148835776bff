"""Population tier: cohort-sampled rounds that never build an ``[N, D]``
model stack (counterpart of ``repro/core/engine/population.py``,
DESIGN.md §11).

A FedTest round only computes on its sampled cohort, and every client
outside it already has defined semantics: zero aggregation weight
(``renormalize_over_subset``), a frozen score (the participation mask),
a masked tester row, and a cross-test column equal to the global
model's accuracy (a client that sends nothing is seen as the stale
global copy, as ``mask_models`` makes it on the dense backend). So the
round runs on a gathered ``[C, ...]`` model stack (:class:`CohortModels`)
while the population state stays a dense ``[N]`` ``ScoreState``:

* **gather**  — :func:`cohort_from_mask` turns the round's participation
  mask into C slot indices; the training batches and the model stack are
  gathered to ``[C]``, never broadcast to ``[N]``;
* **compute** — the unchanged :class:`RoundProgram` drives
  :class:`PopulationBackend`: vmapped local training and the attack over
  ``[C]``, cross-testing in ``[K, block]`` tiles
  (:func:`~repro_torch.core.cross_testing.cross_test_tiled`), and the
  ``weighted_aggregate`` kernel over the cohort stack (every other
  summand of the population's sum has weight exactly 0);
* **scatter** — the cohort's columns go into a ``[K, N]`` matrix of the
  global model's accuracies and its losses into zeros, rebuilding the
  arrays the program scores.

The port holds this tier to its own dense engine: discrete outputs
exactly, floats to the last bits (a vmap over C rows and one over N may
round differently).

**Cohort sharding** (the reference's ``mesh`` / ``axis``): given a
``torch.distributed`` group of W ranks (``PopulationTrainer.group``),
rank r holds the contiguous slots ``[r·C/W, (r+1)·C/W)`` of the cohort,
and a C that W does not divide is refused. Every rank draws the whole
round (the same generator) and keeps the replicated ``[N]`` state;
training, the attack, the mask and the encoding run on its own slots,
its ``[K, C/W]`` cross-test columns and ``[C/W]`` losses and server
accuracies are gathered in slot order, and step 7 gathers the cohort
stack (or its payloads) and runs the unsharded tier's reduction on every
rank. The reference holds its GSPMD sharding only to suppression; the
port holds its sharded tier to its unsharded one: every discrete field
and the weights exactly, the params to the last bits.

The sentinel N marks an unfilled slot. torch has no ``mode="drop"``
scatter, and an out-of-range index is a device-side assert on the card,
so no tensor is ever indexed with it: gathers clamp it to N - 1, and a
scatter writes into its base widened by one row at index N, which the
sentinel slots hit and which is then dropped.

**No host read.** The round reads nothing to the host: the cohort plan
stays on the device (``CohortPlan.ids`` is for checks outside the round),
the attack picks its slots with ``torch.where`` (``Attack.apply_slots``),
``random_weights``' noise is :class:`KeyedNoise`, a counter-based draw
keyed on (run seed, round, client) and made where it is used, and both
providers gather on the device (a ``SyntheticPopulation`` draws its
shards from keyed Philox counters). So ``rounds_per_call`` > 1 runs the
driver's chunk on this round: one CUDA graph on the card, R replays
bitwise R eager rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple, Sequence, Tuple

import torch
from torch.func import vmap

from repro_torch import tracing
from repro_torch.core.cross_testing import CROSSTEST_IMPLS, cross_test_tiled
from repro_torch.core.engine.backends import _flatten_updates
from repro_torch.core.engine.driver import (
    ChunkBuffers, FederatedTrainer, RoundState, _flat_state)
from repro_torch.core.engine.program import RoundDraws
from repro_torch.data.pipeline import batch_indices_from_uniforms
from repro_torch.kernels.weighted_aggregate import aggregate_pytree
from repro_torch.utils import tree_add_vector, tree_map
from repro_torch.utils.seeding import keyed_normal, philox_key

# the attack-noise stream's constant: a malicious cohort member's noise is
# drawn from (run seed, NOISE_STREAM, round, client) alone
NOISE_STREAM = 12


def cohort_from_mask(part_mask: torch.Tensor, capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The round's participation mask ``[N]`` -> its cohort plan
    ``(idx, valid, eff_mask)``:

    * ``idx [capacity]`` int64 — the sampled clients in ascending order,
      padded with the sentinel N;
    * ``valid [capacity]`` f32 — 1 where the slot holds a client;
    * ``eff_mask [N]`` — the mask the round honours: a draw that
      oversubscribes the buffer keeps its first ``capacity`` clients in
      index order and the rest revert to non-sampled; a draw that fits is
      ``part_mask`` itself, bitwise."""
    n = part_mask.shape[0]
    ids = torch.where(part_mask > 0,
                      torch.arange(n, device=part_mask.device),
                      torch.full((), n, device=part_mask.device))
    idx = torch.sort(ids).values[:capacity]
    valid = (idx < n).to(torch.float32)
    kept = (torch.cumsum(part_mask, 0) <= capacity).to(part_mask.dtype)
    return idx, valid, part_mask * kept


def recruit_testers(tester_ids: torch.Tensor, idx: torch.Tensor,
                    valid: torch.Tensor, num_users: int) -> torch.Tensor:
    """``testers_from_cohort``: the selector's ``[K]`` ids remapped onto
    the cohort, ``idx[id mod count]``, ``count`` the filled slots of
    ``valid`` (at least 1, the reference's ``jnp.maximum(jnp.sum(valid),
    1)``) counted on the device, clamped below N as the reference clamps
    them; int32."""
    count = valid.sum().long().clamp(min=1)
    slot = tester_ids.long() % count
    return torch.clamp(idx[slot], max=num_users - 1).to(torch.int32)


class KeyedNoise(NamedTuple):
    """``random_weights``' draws for the population tier, made where they
    are used (:meth:`block`), never stored: client c's noise for leaf l
    in round r is :func:`~repro_torch.utils.seeding.keyed_normal` under
    ``key`` at counter ``(element // 4, l, c, r)``, so it is a function of
    (run seed, ``NOISE_STREAM``, round, client) alone, whichever other
    clients are sampled, and the round reads no id to the host."""

    key: Any            # (k0, k1): host ints, or a chunk's [2] int64 buffer
    round_idx: Any      # the host int, or a chunk's 0-d device counter

    def block(self, leaf: int, slots: range, clients: torch.Tensor,
              lo: int, hi: int) -> torch.Tensor:
        """Elements ``lo..hi`` of leaf ``leaf``'s noise for ``clients``
        (``[rows]`` int64, the clients of ``slots``): ``[rows, hi - lo]``
        f32."""
        with tracing.span("noise"):
            return keyed_normal(self.key, (leaf, clients[:, None],
                                           self.round_idx), lo, hi)


class RecordedNoise(NamedTuple):
    """Noise given by slot: ``by_slot`` maps a slot to its client's
    draws, one tensor a leaf in ``tree_leaves`` order; a slot it lacks
    reads zeros. The parity tests replay the reference's per-client noise
    through it."""

    by_slot: Mapping[int, Sequence[torch.Tensor]]

    def block(self, leaf: int, slots: range, clients: torch.Tensor,
              lo: int, hi: int) -> torch.Tensor:
        rows = [self.by_slot[s][leaf].reshape(-1)[lo:hi].float()
                if s in self.by_slot else
                torch.zeros((hi - lo,), device=clients.device)
                for s in slots]
        return torch.stack(rows)


def noise_key(seed: int) -> Tuple[int, int]:
    """The Philox key of a run's attack noise."""
    return philox_key(seed, NOISE_STREAM)


def client_noise(seed: int, round_idx: int, client: int, leaves):
    """``random_weights``' draws for one client in one round, a standard
    normal like each of ``leaves``: the values :class:`KeyedNoise` makes
    for that client's slot, bitwise. A dense engine given them plays the
    population tier's noise."""
    # one Philox key for every leaf: the leaf index is a counter word
    words, dev = noise_key(seed), leaves[0].device
    return [keyed_normal(words, (i, client, round_idx), 0, leaf.numel(),
                         device=dev)[0].reshape(leaf.shape)
            for i, leaf in enumerate(leaves)]


class CohortPlan(NamedTuple):
    """The round's cohort, drawn once (``PopulationTrainer.draw``) and
    carried in ``RoundDraws.cohort``: ``idx`` maps slots to clients
    (sentinel N: unfilled) and ``valid`` flags the filled slots. Both
    stay on the device: the round reads neither to the host."""

    idx: torch.Tensor          # [C] int64 (N: unfilled)
    valid: torch.Tensor        # [C] f32 1/0

    @property
    def ids(self) -> Tuple[int, ...]:
        """The filled slots' clients as host ints, ascending: a read to
        the host, for checks and logs outside the round."""
        return tuple(int(i) for i in self.idx[self.valid > 0].tolist())


class CohortModels(NamedTuple):
    """The population tier's model handle: a ``[C]`` gathered stack, the
    round's :class:`CohortPlan`, and the round's global model (what every
    column outside the cohort reports)."""

    stack: Any                 # param tree, leaves [C, ...]
    plan: CohortPlan
    global_ref: Any            # the unstacked global params


class PopulationBackend:
    """Cohort-gather exchange: compute on ``[C]``, report as ``[N]`` and
    ``[K, N]``. ``tx, ty`` arrive gathered to the K testers' rows (the
    population tier holds no ``[N, eval_batch]`` test stack), which is why
    :meth:`cross_test` ignores ``tester_ids``."""

    name = "population"

    def __init__(self, num_users: int, capacity: int,
                 crosstest_impl: str = "batched", *, block: int = 0,
                 train_block: int = 0, group=None):
        if crosstest_impl not in CROSSTEST_IMPLS:
            raise ValueError(f"crosstest_impl must be one of "
                             f"{CROSSTEST_IMPLS}, got {crosstest_impl!r}")
        if not 1 <= capacity <= num_users:
            raise ValueError(
                f"cohort capacity must be in [1, num_users={num_users}], "
                f"got {capacity}")
        world = 1 if group is None else group.world_size
        if capacity % world:
            raise ValueError(
                f"cohort {capacity} must divide evenly across {world} "
                "ranks for the cohort sharding")
        self.num_users = num_users
        self.capacity = capacity
        self.crosstest_impl = crosstest_impl
        self.block = block
        self.train_block = train_block
        self.group = group
        # this rank's slots [lo, lo + shard) of the cohort
        self.shard = capacity // world
        self.lo = 0 if group is None else group.rank * self.shard

    def _own(self, t):
        """This rank's slots of a slot-indexed array."""
        return t[self.lo:self.lo + self.shard]

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's slots ``[shard, ...]`` -> ``[C, ...]`` in slot
        order."""
        return t if self.group is None else self.group.all_gather(t)

    def _gather_stack(self, stack):
        if self.group is None:
            return stack
        return tree_map(lambda t: t.reshape((-1,) + t.shape[2:]),
                        self.group.gather_tree(stack))

    def _safe_idx(self, plan: CohortPlan) -> torch.Tensor:
        # sentinel slots gather client N - 1; their results never escape
        # (zero weight, unwritten scatters)
        return plan.idx.clamp(max=self.num_users - 1)

    def _cohort_weights(self, plan: CohortPlan, weights: torch.Tensor):
        """The ``[N]`` weights gathered to the slots; ``valid`` zeroes the
        sentinel slots, whose gathered weight is client N - 1's."""
        return weights[self._safe_idx(plan)] * plan.valid

    @staticmethod
    def _scatter(base: torch.Tensor, plan: CohortPlan, values: torch.Tensor,
                 dim: int = -1) -> torch.Tensor:
        """``base`` with the filled slots' ``values`` written at their
        clients along ``dim``, with no host count: the write goes into
        ``base`` widened by one row at index N, which every sentinel slot
        hits and which is then dropped, so no kept row is written twice
        (``index_copy`` leaves the winner of a duplicate undefined on the
        card)."""
        dim = dim % base.dim()
        n = base.shape[dim]
        pad = list(base.shape)
        pad[dim] = 1
        wide = torch.cat([base, base.new_zeros(pad)], dim)
        wide.index_copy_(dim, plan.idx, values.to(base.dtype))
        return wide.narrow(dim, 0, n).contiguous()

    # ------------------------------------------------------ backend protocol
    def train(self, local_train, global_params, bx, by):
        """Broadcast to this rank's slots + local phase, vmapped over
        groups of ``train_block`` slots (0: all at once). ``bx`` packs
        the cohort plan with the gathered batches of all C slots:
        ``(plan, x)``."""
        plan, cx = bx
        stack = tree_map(
            lambda x: x[None].expand((self.shard,) + x.shape),
            global_params)
        stack, loss = vmap(local_train, chunk_size=self.train_block or None)(
            stack, self._own(cx), self._own(by))
        loss = self._gather(loss)
        models = CohortModels(stack, plan, global_params)
        # clients outside the cohort report 0; the program's loss metric
        # masks them out
        losses = self._scatter(
            torch.zeros((self.num_users,), dtype=loss.dtype,
                        device=loss.device), plan, loss)
        return models, losses

    def apply_attack(self, attack, noise, models, global_params, actx):
        """Step 3 on this rank's slots, on the device: a slot is corrupted
        as its client where that client is malicious and the slot is
        filled (:meth:`Attack.apply_slots`)."""
        plan = models.plan
        clients = self._own(self._safe_idx(plan))
        bad = (attack.malicious_mask(self.num_users, clients.device)[clients]
               * self._own(plan.valid)) > 0
        stack = attack.apply_slots(noise, models.stack, global_params, actx,
                                   clients, bad,
                                   range(self.lo, self.lo + self.shard))
        return models._replace(stack=stack)

    def mask_models(self, models, global_params, part_mask):
        my_part = part_mask[self._own(self._safe_idx(models.plan))]
        stack = tree_map(
            lambda t, g: torch.where(
                my_part.reshape((-1,) + (1,) * (t.dim() - 1)) > 0,
                t, g[None].to(t.dtype)),
            models.stack, global_params)
        return models._replace(stack=stack)

    def cross_test(self, eval_fn, models, tx, ty, tester_ids):
        """Step 4: the ``[K, N]`` matrix. A column outside the cohort is
        the tester's accuracy on the global model, the value the dense
        backend measures on a masked slot."""
        acc_c = cross_test_tiled(eval_fn, models.stack, tx, ty,
                                 block=self.block,
                                 impl=self.crosstest_impl)   # [K, shard]
        acc_c = self._gather(acc_c.T.contiguous()).T              # [K, C]
        base = vmap(lambda x, y: eval_fn(models.global_ref, x, y))(tx, ty)
        acc = base[:, None].expand(base.shape[0], self.num_users)
        return self._scatter(acc, models.plan, acc_c)

    def server_eval(self, eval_fn, models, sx, sy):
        def run():
            accs = self._gather(
                vmap(lambda p: eval_fn(p, sx, sy))(models.stack))
            base = eval_fn(models.global_ref, sx, sy)
            return self._scatter(base.expand(self.num_users), models.plan,
                                 accs)
        return run

    def updates(self, models, global_params):
        raise NotImplementedError(
            "the population tier refuses to build the [N, D] update "
            "matrix: aggregators that need it (krum, trimmed_mean, median, "
            "the coordinate-wise combine) are the replication wall this "
            "tier exists to break. Use a score-weighted aggregator "
            "(fedtest, fedavg, ...) or the dense engine.")

    def weighted_sum(self, models, weights, global_params):
        """Step 7 over the cohort stack: ``weights`` is the ``[N]``
        simplex, exactly 0 outside the (effective) cohort, so this is the
        population's sum."""
        return aggregate_pytree(self._gather_stack(models.stack),
                                self._cohort_weights(models.plan, weights))

    def compress_exchange(self, compressor, models, global_params,
                          comp_state, part_mask):
        """Step 3c on the cohort's rows. The ``[N, D]`` error feedback
        stays population-dense (DESIGN.md §12): only the cohort's rows are
        gathered, encoded and written back. The payloads go out tagged
        with the plan, ``(plan, payloads)``, so that :meth:`compressed_sum`
        can gather the ``[N]`` weights to their slots."""
        plan = models.plan
        safe = self._own(self._safe_idx(plan))
        updates = _flatten_updates(models.stack, global_params)  # [shard, D]
        state_rows = comp_state[safe]
        payloads, new_rows = compressor.encode(state_rows, updates)
        decoded = compressor.decode(payloads)
        eff = self._own(plan.valid) * (part_mask[safe]
                                       if part_mask is not None else 1.0)
        # masked and sentinel slots sent nothing: their rows stay and
        # their decoded update is exactly 0
        keep = (eff > 0)[:, None]
        new_rows = self._gather(torch.where(keep, new_rows, state_rows))
        decoded = torch.where(keep, decoded, 0.0)
        new_state = self._scatter(comp_state, plan, new_rows, dim=0)
        stack = tree_add_vector(global_params, decoded)
        return (models._replace(stack=stack), (plan, payloads), decoded,
                new_state)

    def compressed_sum(self, compressor, payloads, decoded, weights):
        plan, payloads = payloads
        if self.group is not None:
            payloads = {k: self._gather(v) for k, v in payloads.items()}
            decoded = (self._gather(decoded) if compressor.reads_decoded
                       else None)
        return compressor.aggregate(payloads, decoded,
                                    self._cohort_weights(plan, weights))


@dataclasses.dataclass
class PopulationTrainer(FederatedTrainer):
    """The single-device driver of the population tier (DESIGN.md §11).

    A :class:`FederatedTrainer` whose round gathers the sampled cohort
    before the program runs. It draws the dense engine's stream in the
    same order (selector, participation, the ``[N, steps, batch]`` batch
    uniforms, then faults and lies), so with a noise-free attack a small
    run is the dense run; only the cohort's rows of the batch data are
    read. A malicious slot's noise is :class:`KeyedNoise`, made leaf by
    leaf where the attack uses it, never from the round's generator. The
    round reads nothing to the host: the cohort plan, the attack's slots,
    the noise's counters and every metric stay on the device. The round
    state is the dense :class:`RoundState`, so checkpoints, manifests and
    bitwise resume are inherited.

    ``rounds_per_call`` = R > 1 runs the inherited chunk driver on
    :meth:`_chunk_round`, this tier's round on the static buffers (one
    CUDA graph of it on the card, replayed R times), bitwise R
    :meth:`run_round` calls. The chunk reads the provider it was
    captured on (a ``SyntheticPopulation``'s Philox key is in the
    capture), so a chunk on another raises; a ``group`` is refused.

    ``fed.cohort`` (0: ``fed.num_users``) is the slot capacity C, which
    ``FedConfig`` checks; ``crosstest_block`` tiles the tester eval in ``[K,
    block]`` tiles; ``train_block`` trains the slots in vmapped groups of
    that many (0: one group a rank). A vmap's width changes how the card
    rounds a slot's training (its grouped convolutions), so a run at
    ``train_block`` = C / W is bitwise the cohort sharded over W ranks,
    and one at 0 parts from it by rounding; ``testers_from_cohort`` remaps the selector's tester
    ids onto cohort members (slot = id mod the cohort's size), since at
    C ≪ N a population-wide tester is almost never sampled and the
    scores degenerate to zero. Data comes from a population provider
    (:mod:`repro_torch.data.population`). ``group`` (a
    :class:`~repro_torch.launch.mesh.RankGroup`) shards the cohort's
    slots over its ranks, each on ``group.device`` holding the replicated
    state."""

    crosstest_block: int = 0
    train_block: int = 0
    testers_from_cohort: bool = False
    group: Any = None

    def __post_init__(self):
        self.capacity = self.fed.cohort or self.fed.num_users
        if self.eval_resample_every:
            raise ValueError(
                "eval_resample_every is a dense-driver feature (it draws "
                "[N, eval_batch] gather indices); the population tier "
                "gathers tester rows directly")
        if self.group is not None:
            if self.rounds_per_call > 1:
                raise ValueError(
                    "the sharded population tier runs one round a call "
                    "(its round gathers over the group's ranks, as the "
                    "pod round does); rounds_per_call > 1 runs on one "
                    "device")
            self.device = self.group.device
        super().__post_init__()
        if self.program.needs_updates:
            raise ValueError(
                f"aggregator {self.program.aggregator.name!r} needs the "
                "[N, D] update matrix — the population tier refuses it "
                "(that matrix is the replication wall). Use a "
                "score-weighted aggregator or the dense engine.")

    def _make_backend(self, impl: str):
        return PopulationBackend(self.fed.num_users, self.capacity, impl,
                                 block=self.crosstest_block,
                                 train_block=self.train_block,
                                 group=self.group)

    def draw(self, state: RoundState, data, key=None) -> RoundDraws:
        """The round's draws: the dense engine's stream, the batch
        uniforms gathered to the cohort's rows before any index is made,
        and the attack's :class:`KeyedNoise` under ``key`` (default: the
        run seed's :func:`noise_key`; a chunk passes its buffer)."""
        fed, program = self.fed, self.program
        n, gen = fed.num_users, state.gen
        with tracing.span("draw"):
            tester_ids, part_mask = program.draw_selection(
                gen, state.round_idx, state.scores.scores)
            idx, valid, eff_mask = cohort_from_mask(part_mask,
                                                    self.capacity)
            if self.testers_from_cohort:
                tester_ids = recruit_testers(tester_ids, idx, valid, n)
            safe = idx.clamp(max=n - 1)
            u = torch.rand((n, fed.local_steps, self.train.batch_size),
                           generator=gen, device=gen.device)
            batch_idx = batch_indices_from_uniforms(u[safe],
                                                    data.train_counts[safe])
            noise = None
            if program.attack.needs_noise:
                noise = KeyedNoise(noise_key(state.seed) if key is None
                                   else key, state.round_idx)
            fault_draws, lies = program.draw_seams(gen)
        return RoundDraws(batch_idx, tester_ids, eff_mask, noise,
                          fault_draws=fault_draws, lies=lies,
                          cohort=CohortPlan(idx, valid))

    def _play_cohort(self, global_params, scores, comp_state, round_idx,
                     data, draws: RoundDraws):
        """Steps 1-7 on the round's cohort; ``round_idx`` is the host int
        or the chunk's device counter."""
        plan = draws.cohort
        with tracing.span("shards"):
            cx, cy = data.cohort_train(
                plan.idx.clamp(max=self.fed.num_users - 1))
            rows = torch.arange(self.capacity,
                                device=plan.idx.device)[:, None, None]
            bx, by = cx[rows, draws.batch_idx], cy[rows, draws.batch_idx]
            tx, ty = data.tester_batches(draws.tester_ids, self.eval_batch)
        return self.program.run(
            self.backend, global_params, scores,
            bx=(plan, bx), by=by, tx=tx, ty=ty, draws=draws,
            round_idx=round_idx, counts=data.train_counts,
            server_data=data.server_batch(self.eval_batch),
            comp_state=comp_state)

    def run_round(self, state: RoundState, data, draws=None):
        """One round on the cohort; ``draws`` replaces the round's own
        (its ``batch_idx`` the cohort's rows, its ``part_mask`` the
        honoured mask, its ``cohort`` that mask's :class:`CohortPlan`)."""
        with tracing.span("round", state.round_idx):
            if draws is None:
                draws = self.draw(state, data)
            new_global, new_scores, new_comp, metrics = self._play_cohort(
                state.global_params, state.scores, state.comp_state,
                state.round_idx, data, draws)
        return state._replace(global_params=new_global, scores=new_scores,
                              round_idx=state.round_idx + 1,
                              comp_state=new_comp), metrics

    # ------------------------------------------------------ the chunk body
    def _chunk_round(self, buf: ChunkBuffers):
        """This tier's round on the static buffers, its results written
        back into them and the counter advanced: the body a chunk
        captures. It reads the provider, the round counter, the buffers'
        generator and their noise key."""
        state = RoundState(buf.params, buf.scores, buf.counter, buf.gen,
                           buf.comp, buf.seed)
        draws = self.draw(state, buf.data, key=(buf.key[0], buf.key[1]))
        new_global, new_scores, new_comp, metrics = self._play_cohort(
            buf.params, buf.scores, buf.comp, buf.counter, buf.data, draws)
        for dst, src in zip(buf.tensors(),
                            _flat_state(new_global, new_scores, new_comp)):
            dst.copy_(src)
        buf.counter.add_(1)
        return metrics

    def _load_seed(self, buf: ChunkBuffers) -> None:
        """The noise key of ``buf.seed`` into the buffers' own, which the
        captured round reads."""
        key = torch.tensor(noise_key(buf.seed), dtype=torch.int64)
        if buf.key is None:
            buf.key = key.to(self.device)
        else:
            buf.key.copy_(key)
