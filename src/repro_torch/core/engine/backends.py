"""Exchange backends (counterpart of ``repro/core/engine/backends.py``):
the topology-specific third of the round engine.

* ``local`` — one device holds the N client models as a stacked
  ``[N, ...]`` param tree; local training, cross-testing (``batched``, or
  the ``reference`` loop) and the server's eval run under
  ``torch.func.vmap`` over the client axis, and aggregation is the
  ``weighted_aggregate`` kernel, one launch a table of param leaves. It
  also builds the ``[N, D]`` f32 update matrix and runs the compressed
  exchange (encode with error feedback, decode, and the weighted sum in
  update space).
* ``ring`` / ``allgather`` — the pod: one client a rank of a
  ``torch.distributed`` group (:class:`~repro_torch.launch.mesh.RankGroup`).
  Cross-testing either passes the models round the ring, N - 1 hops of
  the visiting model (peak memory: own + visiting; the analogue of the
  paper's D2D exchange), or gathers every model at once (the paper's
  broadcast), keeping the stack for the update matrix and the sum.

Every backend hands the program *replicated* ``[N]`` and ``[K, N]``
arrays, so scoring is the single-device code path. Where the reference's
pod sums with ``psum`` (in whatever order its all-reduce picks), the
port's gathers the operands exactly and runs the local backend's own
reduction on every rank: the models into ``aggregate_pytree``, the
update rows into the ``[N, D]`` matrix that ``robust_combine`` reads,
each rank's new error-feedback row into the ``[N, D]`` buffer, and the
compressed payloads (int8 codes and scales) into ``compressor.aggregate``
(``dequant_aggregate`` on the card). So ring and allgather give bitwise
the same state, and a resumed run bitwise the unbroken one, for both.
:func:`make_pod_round` builds the pod's round function; the pod's
driver is :class:`~repro_torch.core.engine.driver.PodTrainer`.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from repro_torch.config import FedConfig, TrainConfig
from repro_torch.core.cross_testing import (
    CROSSTEST_IMPLS, cross_test_accuracies)
from repro_torch.core.engine.program import RoundDraws, RoundProgram
from repro_torch.kernels.weighted_aggregate import aggregate_pytree
from repro_torch.utils import (
    PackedTree, tree_add_vector, tree_leaves, tree_map)


def _flatten_updates(stacked, global_params) -> torch.Tensor:
    """[N, D] float32 matrix of flattened client updates (``tree_leaves``
    order, each leaf raveled)."""
    parts = tree_leaves(tree_map(
        lambda s, g: (s.float() - g.float()[None]).reshape(s.shape[0], -1),
        stacked, global_params))
    return torch.cat(parts, dim=1)


class LocalBackend:
    """Single-device backend: clients stacked on a leading [N] axis."""

    name = "local"

    def __init__(self, num_users: int, crosstest_impl: str = "batched"):
        if crosstest_impl not in CROSSTEST_IMPLS:
            raise ValueError(f"crosstest_impl must be one of "
                             f"{CROSSTEST_IMPLS}, got {crosstest_impl!r}")
        self.num_users = num_users
        self.crosstest_impl = crosstest_impl

    def train(self, local_train, global_params, bx, by):
        """Broadcast + local phase -> (models, per-client losses [N])."""
        stacked = tree_map(
            lambda x: x[None].expand((self.num_users,) + x.shape),
            global_params)
        return vmap(local_train)(stacked, bx, by)

    def apply_attack(self, attack, noise, models, global_params, actx):
        """Step 3: corrupt the malicious clients' models."""
        return attack.apply(noise, models, global_params, actx)

    def mask_models(self, models, global_params, part_mask):
        """Step 3b: revert non-participants' slots to the global model."""
        return tree_map(
            lambda t, g: torch.where(
                part_mask.reshape((-1,) + (1,) * (t.dim() - 1)) > 0,
                t, g[None].to(t.dtype)),
            models, global_params)

    def cross_test(self, eval_fn, models, tx, ty, tester_ids):
        """Step 4: the [K, N] accuracy matrix."""
        ids = tester_ids.long()
        return cross_test_accuracies(eval_fn, models, tx[ids], ty[ids],
                                     impl=self.crosstest_impl)

    def server_eval(self, eval_fn, models, sx, sy):
        """Step 6: a closure giving every client model's accuracy [N] on
        the server's held-out set."""
        return lambda: vmap(lambda p: eval_fn(p, sx, sy))(models)

    def updates(self, models, global_params):
        """The [N, D] float32 flattened update matrix."""
        return _flatten_updates(models, global_params)

    def weighted_sum(self, models, weights, global_params):
        """Step 7: sum_c w_c * model_c -> new global."""
        return aggregate_pytree(models, weights)

    def compress_exchange(self, compressor, models, global_params,
                          comp_state, part_mask):
        """Step 3c: encode every client's flat update with error feedback
        (all rows at once, each with one row's arithmetic) and rebuild
        the models from the decoded updates. Returns ``(models, payloads,
        decoded, new_comp_state)``."""
        updates = _flatten_updates(models, global_params)       # [N, D]
        payloads, new_state = compressor.encode(comp_state, updates)
        decoded = compressor.decode(payloads)                   # [N, D]
        if part_mask is not None:
            # a masked client transmitted nothing: its error buffer must
            # not be flushed and its decoded update is exactly 0, so its
            # rebuilt slot is the stale global model
            keep = (part_mask > 0)[:, None]
            new_state = torch.where(keep, new_state, comp_state)
            decoded = torch.where(keep, decoded, 0.0)
        models = tree_add_vector(global_params, decoded)
        return models, payloads, decoded, new_state

    def compressed_sum(self, compressor, payloads, decoded, weights):
        """Step 7, compressed: ``sum_c w_c * decoded_c`` -> flat [D] f32."""
        return compressor.aggregate(payloads, decoded, weights)


def _flat_update(params, global_params) -> torch.Tensor:
    """One client's ``[1, D]`` f32 update row, ``_flatten_updates``'s
    layout."""
    return torch.cat([(p.float() - g.float()).reshape(1, -1)
                      for p, g in zip(tree_leaves(params),
                                      tree_leaves(global_params))], dim=1)


def ring_cross_test(eval_fn, my_params, tx, ty, group, num_clients: int,
                    impl: str = "batched") -> torch.Tensor:
    """Every rank measures every client's model on its own test rows:
    ``[num_clients]``, entry c the accuracy of client c's model. The
    models travel round the ring (rank r sends to r + 1 and receives from
    r - 1), N - 1 hops of the visiting model, so the peak is own +
    visiting. ``batched`` issues the next hop before the eval, so the
    transfer overlaps it; ``reference`` issues it after. Both evaluate the
    same pre-hop tensors, so the two are bitwise equal."""
    visiting = PackedTree.of(my_params)
    acc = [None] * num_clients
    for step in range(num_clients):
        last = step == num_clients - 1
        pending = (group.hop_start(visiting)
                   if impl == "batched" and not last else None)
        # the model reaching this rank after `step` hops is rank - step's
        acc[(group.rank - step) % num_clients] = eval_fn(visiting.tree(),
                                                         tx, ty)
        if not last:
            visiting = group.hop_finish(pending if pending is not None
                                        else group.hop_start(visiting))
    return torch.stack(acc)


class PodBackend:
    """One client a rank of ``group``: the mechanics the two pod exchanges
    share. Models are the rank's own param tree; every array the program
    reads is gathered to its replicated ``[N]`` / ``[K, N]`` / ``[N, D]``
    form. Subclasses differ in how a tester sees the other clients'
    models; :class:`AllgatherBackend` keeps the gathered stack for the
    round (``gathered``), so nothing is exchanged twice."""

    name = "pod"

    def __init__(self, group, num_clients: int,
                 crosstest_impl: str = "batched"):
        if crosstest_impl not in CROSSTEST_IMPLS:
            raise ValueError(f"crosstest_impl must be one of "
                             f"{CROSSTEST_IMPLS}, got {crosstest_impl!r}")
        self.group = group
        self.num_clients = num_clients
        self.crosstest_impl = crosstest_impl
        self.gathered = None

    def train(self, local_train, global_params, bx, by):
        """This rank's local phase on its own ``bx [steps, batch, ...]``;
        the losses gathered to ``[N]``. Starts the round: the gathered
        stack of the last one is dropped."""
        self.gathered = None
        params, loss = local_train(global_params, bx, by)
        return params, self.group.all_gather(loss.reshape(1))

    def apply_attack(self, attack, noise, models, global_params, actx):
        return attack.apply_local(noise, models, global_params,
                                  self.group.rank, self.num_clients, actx)

    def mask_models(self, models, global_params, part_mask):
        mine = part_mask[self.group.rank]
        return tree_map(lambda p, g: torch.where(mine > 0, p, g.to(p.dtype)),
                        models, global_params)

    def _acc_matrix(self, acc_row, tester_ids):
        """This rank's ``[N]`` row -> the replicated ``[K, N]`` tester
        rows: one small gather (N² floats) of every rank's row."""
        full = self.group.all_gather(acc_row[None])              # [N, N]
        return full[tester_ids.long()]

    def _stack(self, models):
        """Every client's model stacked ``[N, ...]``: the round's gathered
        stack where cross-testing made one."""
        if self.gathered is None:
            return self.group.gather_tree(models)
        return self.gathered

    def server_eval(self, eval_fn, models, sx, sy):
        return lambda: self.group.all_gather(
            eval_fn(models, sx, sy).reshape(1))                  # [N]

    def updates(self, models, global_params):
        if self.gathered is not None:
            return _flatten_updates(self.gathered, global_params)
        return self.group.all_gather(_flat_update(models, global_params))

    def weighted_sum(self, models, weights, global_params):
        return aggregate_pytree(self._stack(models), weights)

    def compress_exchange(self, compressor, models, global_params,
                          comp_state, part_mask):
        """Step 3c on this rank's row: its update encoded against its own
        error-feedback row (a ``[1, D]`` call, the local backend's
        arithmetic of one row), and the new rows gathered into the
        replicated ``[N, D]`` buffer."""
        r = self.group.rank
        state_row = comp_state[r:r + 1]
        payload, new_row = compressor.encode(
            state_row, _flat_update(models, global_params))
        decoded = compressor.decode(payload)                     # [1, D]
        if part_mask is not None:
            keep = part_mask[r] > 0
            new_row = torch.where(keep, new_row, state_row)
            decoded = torch.where(keep, decoded, 0.0)
        new_state = self.group.all_gather(new_row)               # [N, D]
        models = tree_add_vector(global_params, decoded[0])
        return models, payload, decoded, new_state

    def compressed_sum(self, compressor, payloads, decoded, weights):
        """Step 7, compressed: every rank's payload gathered (for int8 the
        codes and scales, a quarter of the decoded f32's bytes), and the
        decoded rows too where ``compressor.aggregate`` reads them."""
        gathered = {k: self.group.all_gather(v) for k, v in payloads.items()}
        rows = (self.group.all_gather(decoded) if compressor.reads_decoded
                else None)
        return compressor.aggregate(gathered, rows, weights)


class RingBackend(PodBackend):
    """The ring exchange (:func:`ring_cross_test`)."""

    name = "ring"

    def cross_test(self, eval_fn, models, tx, ty, tester_ids):
        acc_row = ring_cross_test(eval_fn, models, tx, ty, self.group,
                                  self.num_clients, self.crosstest_impl)
        return self._acc_matrix(acc_row, tester_ids)


class AllgatherBackend(PodBackend):
    """The paper's broadcast: every rank gathers every model at once (N x
    one model's memory) and evaluates the stack, ``batched`` under one
    vmap or ``reference`` one model at a time. The stack is kept for the
    round's update matrix and weighted sum."""

    name = "allgather"

    def cross_test(self, eval_fn, models, tx, ty, tester_ids):
        self.gathered = everyone = self.group.gather_tree(models)
        if self.crosstest_impl == "batched":
            acc_row = vmap(lambda p: eval_fn(p, tx, ty))(everyone)
        else:
            acc_row = torch.stack([
                eval_fn(tree_map(lambda t, c=c: t[c], everyone), tx, ty)
                for c in range(self.num_clients)])
        return self._acc_matrix(acc_row, tester_ids)


POD_BACKENDS = {"ring": RingBackend, "allgather": AllgatherBackend}


def pod_backend(fed: FedConfig, group, exchange: str,
                crosstest_impl: str) -> PodBackend:
    """The rank's pod backend, with the reference's build-time checks: a
    known exchange, and one client a rank."""
    if exchange not in POD_BACKENDS:
        raise ValueError(f"exchange must be 'ring'|'allgather', "
                         f"got {exchange!r}")
    if fed.num_users != group.world_size:
        raise ValueError(
            f"FedConfig.num_users={fed.num_users} but the group has "
            f"{group.world_size} ranks — the pod pins one client a rank "
            "(refit presets with repro_torch.configs.scenario_for_pod)")
    return POD_BACKENDS[exchange](group, fed.num_users, crosstest_impl)


def make_pod_round(model, fed: FedConfig, train_cfg: TrainConfig, group,
                   counts=None, server_data=None, exchange: str = "ring",
                   crosstest_impl: str = None):
    """The pod's FedTest round on ``group`` (one client a rank, on
    ``group.device``): the same :class:`RoundProgram` as the local
    backend's, on the ring or the all-gather exchange::

      round_fn(global_params, scores, bx, by, tx, ty, draws, round_idx)
        -> (new_global, new_scores, metrics)

    and, with a compressor other than ``identity``, the replicated
    ``[N, D]`` error feedback in and out::

      round_fn(global_params, scores, comp, bx, by, tx, ty, draws,
               round_idx) -> (new_global, new_scores, new_comp, metrics)

    ``global_params``, ``scores``, ``comp`` and ``draws`` (the whole
    round's :class:`RoundDraws`, which every rank draws from the same
    generator) are replicated; ``bx, by`` are this rank's training
    batches ``[steps, batch, ...]`` and ``tx, ty`` its test rows
    ``[eval_batch, ...]``. ``counts`` are the ``[N]`` sample counts (ones
    without them); ``server_data`` the server's ``(sx, sy)``, which a
    ``needs_server_eval`` aggregator requires. The function carries its
    ``program`` and ``backend``."""
    program = RoundProgram(model, fed, train_cfg)
    backend = pod_backend(fed, group, exchange,
                          crosstest_impl or fed.crosstest_impl)
    if program.aggregator.needs_server_eval and server_data is None:
        raise ValueError(
            f"aggregator {program.aggregator.name!r} needs a server-side "
            "eval set; pass server_data=(sx, sy) to the round builder "
            "(e.g. the FederatedDataset's server_x/server_y)")
    counts_t = (torch.ones((fed.num_users,), device=group.device)
                if counts is None else
                torch.as_tensor(counts, device=group.device))

    def play(global_params, scores, comp, bx, by, tx, ty,
             draws: RoundDraws, round_idx):
        return program.run(backend, global_params, scores, bx=bx, by=by,
                           tx=tx, ty=ty, draws=draws, round_idx=round_idx,
                           counts=counts_t, server_data=server_data,
                           comp_state=comp)

    if program.use_compression:
        def round_fn(global_params, scores, comp, bx, by, tx, ty, draws,
                     round_idx):
            return play(global_params, scores, comp, bx, by, tx, ty, draws,
                        round_idx)
    else:
        def round_fn(global_params, scores, bx, by, tx, ty, draws,
                     round_idx):
            new_global, new_scores, _, metrics = play(
                global_params, scores, None, bx, by, tx, ty, draws,
                round_idx)
            return new_global, new_scores, metrics
    round_fn.program, round_fn.backend = program, backend
    return round_fn


def make_distributed_round(model, fed: FedConfig, train_cfg: TrainConfig,
                           group, counts=None, server_data=None):
    """The ring-exchange pod round (:func:`make_pod_round`)."""
    return make_pod_round(model, fed, train_cfg, group, counts, server_data,
                          exchange="ring")


def make_allgather_round(model, fed: FedConfig, train_cfg: TrainConfig,
                         group, counts=None, server_data=None):
    """The all-gather-exchange pod round (:func:`make_pod_round`)."""
    return make_pod_round(model, fed, train_cfg, group, counts, server_data,
                          exchange="allgather")
