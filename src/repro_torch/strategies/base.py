"""Strategy registry machinery + the round-context protocol (counterpart
of ``repro/strategies/base.py``).

Everything a strategy could vary — how aggregation weights are produced,
how malicious clients corrupt their models, how testers are selected —
is resolved to a plain Python object before the round runs. Five
registries live here (the compressors' in ``strategies/compressors.py``):

* ``AGGREGATORS`` — :class:`Aggregator`: ``weights(ctx) -> [N]`` simplex,
  or ``combine(ctx, updates) -> [D]``.
* ``ATTACKS``     — :class:`Attack`: corrupt malicious clients' models.
* ``SELECTORS``   — :class:`Selector`: pick the K tester ids per round.
* ``COALITIONS``  — ``Coalition`` (``strategies/coalition.py``): a
  coordinated member set with a model attack and/or a report transform.
* ``FAULTS``      — :class:`Fault`: the per-round client survival mask.

Randomness differs from the reference in one way: the port's round takes
every random number from its :class:`RoundDraws`
(``repro_torch.core.engine.program``), so the ``key`` a strategy is
handed is a ``torch.Generator`` (selectors) or the draws themselves
(attacks, faults), never a JAX key.
"""
from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.utils import tree_leaves, tree_map


class AttackContext(NamedTuple):
    """Per-round view handed to attack strategies (step 3): the scores
    entering the round and the aggregation weights they imply."""

    scores: torch.Tensor               # [N] moving-average scores (pre-round)
    weights: torch.Tensor              # [N] implied aggregation weights
    # the host int, or a chunk's 0-d int64 device counter
    round_idx: Any

    @property
    def num_users(self) -> int:
        return self.weights.shape[0]


class RoundContext(NamedTuple):
    """Per-round view handed to aggregation strategies."""

    acc_matrix: torch.Tensor           # [K, N] tester-measured accuracies
    tester_ids: torch.Tensor           # [K] ids of this round's testers
    scores: Any                        # ScoreState (moving-average scores)
    counts: torch.Tensor               # [N] per-client sample counts
    # the host int, or a chunk's 0-d int64 device counter
    round_idx: Any
    # [N, D] float32 flattened client updates (trained - global), present
    # only when the aggregator sets ``needs_updates`` or defines
    # ``combine`` (the round builds the matrix at most once)
    updates: Optional[torch.Tensor] = None
    # () -> [N] accuracies of every client model on the server's held-out
    # set; present only when the aggregator sets ``needs_server_eval``
    server_eval: Optional[Callable[[], torch.Tensor]] = None
    # [N] 0/1 participation mask when FedConfig.participation < 1; None
    # means everyone participates
    participation: Optional[torch.Tensor] = None
    # [K] 0/1 mask over the rows of ``acc_matrix``: which of this round's
    # testers reported (``participation[tester_ids]``), None under full
    # participation
    report_mask: Optional[torch.Tensor] = None

    @property
    def num_users(self) -> int:
        return self.counts.shape[0]


class Registry:
    """Name -> strategy-class registry with decorator registration."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable] = {}

    def register(self, name: str, entry: Callable) -> Callable:
        if name in self._entries:
            raise ValueError(
                f"{self.kind} {name!r} is already registered "
                f"({self._entries[name]!r})")
        self._entries[name] = entry
        return entry

    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._entries))

    def get(self, name: str) -> Callable:
        if name in self._entries:
            return self._entries[name]
        raise KeyError(f"unknown {self.kind} {name!r}; registered "
                       f"{self.kind}s: {list(self.names())}")

    def build(self, name: str, kwargs: Optional[Dict[str, Any]] = None,
              defaults: Optional[Dict[str, Any]] = None) -> Any:
        """Instantiate ``name`` with ``kwargs`` (strict) + ``defaults``
        (engine-derived, dropped when the strategy does not take them)."""
        cls = self.get(name)
        kwargs = dict(kwargs or {})
        params = inspect.signature(cls).parameters
        has_var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                         for p in params.values())
        merged = dict(kwargs)
        for k, v in (defaults or {}).items():
            if k not in merged and (has_var_kw or k in params):
                merged[k] = v
        if not has_var_kw:
            bad = [k for k in kwargs if k not in params]
            if bad:
                raise TypeError(
                    f"{self.kind} {name!r} got unexpected kwargs {bad}; "
                    f"accepted: {sorted(p for p in params if p != 'self')}")
        return cls(**merged)


def register(registry: Registry, name: str) -> Callable:
    """``@register(AGGREGATORS, "my_agg")`` class decorator."""
    def deco(entry: Callable) -> Callable:
        registry.register(name, entry)
        entry.name = name
        return entry
    return deco


class Aggregator:
    """Turns a :class:`RoundContext` into an aggregated model update.

    * **weights path** (default): ``weights(ctx)`` returns a ``[N]``
      simplex, which step 7 reduces with the ``weighted_aggregate``
      kernel.
    * **combine path**: an aggregator that is no weighted sum (the
      per-coordinate trimmed mean and median) defines ``combine(ctx,
      updates)``, taking the ``[N, D]`` f32 update matrix to the ``[D]``
      combined update, applied as ``global + unflatten(combined)``. Its
      ``weights`` then serves reporting only (the ``malicious_weight``
      metric). ``combine`` left ``None`` keeps the weights path.

    ``needs_updates`` asks the round for ``ctx.updates``,
    ``needs_server_eval`` for ``ctx.server_eval``.
    ``update_scores(ctx)`` lets stateful schemes (FedTest's moving
    average) evolve the ``ScoreState``; the engine calls it first and
    hands the updated scores back via ``ctx.scores`` before ``weights``
    and ``combine``.
    """

    name = "base"
    needs_updates = False
    needs_server_eval = False
    # optional hook: (ctx, updates [N, D]) -> [D] combined update
    combine = None

    def update_scores(self, ctx: RoundContext):
        return ctx.scores

    def weights(self, ctx: RoundContext) -> torch.Tensor:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<aggregator {self.name}>"


def uses_combine(aggregator: Aggregator) -> bool:
    """True when ``aggregator`` routes through the combine path: the one
    place the ``combine is None`` convention is read."""
    return getattr(aggregator, "combine", None) is not None


def normalize_placement(size: int, placement: str,
                        indices: Optional[Tuple[int, ...]]
                        ) -> Tuple[int, str, Optional[Tuple[int, ...]]]:
    """Validate and normalise a (size, placement, indices) ctor triple.
    Explicit ``indices`` win and define the size."""
    if indices is not None:
        indices = tuple(int(i) for i in indices)
        size = len(indices)
    if placement not in ("last", "first", "spread"):
        raise ValueError(
            f"placement must be 'last'|'first'|'spread', got "
            f"{placement!r}")
    return int(size), placement, indices


def resolve_placement(num_users: int, size: int, placement: str = "last",
                      indices: Optional[Tuple[int, ...]] = None
                      ) -> Tuple[int, ...]:
    """Static client-index set for a named placement."""
    if indices is not None:
        return tuple(int(i) for i in indices)
    if size == 0:
        return ()
    if placement == "first":
        return tuple(range(size))
    if placement == "spread":
        stride = max(1, num_users // size)
        return tuple(sorted(set(
            min(i * stride, num_users - 1) for i in range(size))))
    return tuple(range(num_users - size, num_users))


@functools.lru_cache(maxsize=None)
def placement_mask(num_users: int, indices: Tuple[int, ...],
                   device=None) -> torch.Tensor:
    """0/1 float mask [N] for a static client-index set. Made (a copy
    from the host) at the first call for its arguments, outside a chunk's
    capture, and the same tensor returned after: callers only read it."""
    mask = torch.zeros((num_users,), dtype=torch.float32, device=device)
    mask[list(indices)] = 1.0
    return mask


class Attack:
    """Corrupts the malicious clients' models after local training.

    The malicious index set is static Python data, so the corruption and
    the ``malicious_weight`` metric stay right for any placement.
    ``needs_noise`` asks the round for one standard-normal tensor per
    (malicious client, param leaf) in its :class:`RoundDraws`.
    """

    name = "base"
    needs_noise = False

    def __init__(self, *, num_malicious: int = 0, scale: float = 1.0,
                 placement: str = "last",
                 indices: Optional[Tuple[int, ...]] = None):
        self.num_malicious, self.placement, self._indices = \
            normalize_placement(num_malicious, placement, indices)
        self.scale = float(scale)

    def malicious_indices(self, num_users: int) -> Tuple[int, ...]:
        """Static malicious id set (evaluation-side knowledge only)."""
        return resolve_placement(num_users, self.num_malicious,
                                 self.placement, self._indices)

    def malicious_mask(self, num_users: int, device=None) -> torch.Tensor:
        return placement_mask(num_users, self.malicious_indices(num_users),
                              device)

    def corrupt(self, key, trained, global_params, ctx=None,
                client_idx=None):
        """Produce one malicious client's model (tree -> tree).

        ``key`` is this client's noise — a list of standard-normal
        tensors in ``tree_leaves`` order — for attacks that set
        ``needs_noise``, else None. ``ctx`` is the round's
        :class:`AttackContext` and ``client_idx`` the client's index.
        """
        raise NotImplementedError

    def malicious_set(self, num_users: int) -> frozenset:
        """:meth:`malicious_indices` as a set, built once for each N (a
        population of 10⁵ holds tens of thousands of ids)."""
        sets = self.__dict__.setdefault("_malicious_sets", {})
        if num_users not in sets:
            sets[num_users] = frozenset(self.malicious_indices(num_users))
        return sets[num_users]

    def apply(self, noise, stacked_params, global_params, ctx=None):
        """Swap corrupted models into the malicious slots of the dense
        stack, slot c holding client c. ``noise`` maps a malicious client
        index to its draws."""
        num_users = tree_leaves(stacked_params)[0].shape[0]
        slots = self.malicious_indices(num_users)
        if not slots:
            return stacked_params
        bad = [self.corrupt(noise[c] if noise is not None else None,
                            tree_map(lambda a, _c=c: a[_c], stacked_params),
                            global_params, ctx, c)
               for c in slots]

        def merge(stack, *bad_leaves):
            out = stack.clone()
            for s, bl in zip(slots, bad_leaves):
                out[s] = bl
            return out

        return tree_map(merge, stacked_params, *bad)

    def apply_slots(self, noise, stack, global_params, ctx, clients, bad,
                    slots):
        """Step 3 slot-wise, on the device (the population tier): every
        slot's corrupted model (:meth:`corrupt_slots`), kept where ``bad``
        and the trained model elsewhere, ``torch.where(bad, corrupted,
        trained)``. ``clients [S]`` int64 names each slot's client (as a
        device tensor, so nothing is read to the host), ``bad [S]`` bool
        flags a filled slot of a malicious client, and ``slots`` is the
        slots' host range in the cohort (a :class:`RecordedNoise` reads
        by it). A slot is corrupted bitwise as :meth:`apply` corrupts its
        client."""
        if not self.malicious_indices(ctx.num_users):
            return stack
        corrupted = self.corrupt_slots(noise, stack, global_params, ctx,
                                       clients, slots)

        def pick(t, b):
            keep = bad.reshape((-1,) + (1,) * (t.dim() - 1))
            return torch.where(keep, b.to(t.dtype), t)
        return tree_map(pick, stack, corrupted)

    def corrupt_slots(self, noise, stack, global_params, ctx, clients,
                      slots):
        """Every slot's corrupted model, leaves ``[S, ...]``. ``corrupt``
        is elementwise over the tree for every attack without noise, so
        it broadcasts over the slot axis with ``clients`` as the client
        index; an attack with noise overrides this."""
        return self.corrupt(None, stack, global_params, ctx, clients)

    def apply_local(self, noise, params, global_params, client_idx: int,
                    num_users: int, ctx=None):
        """One client's step 3, the pod backends' (one client a rank):
        ``params`` is that client's tree, with no client axis. A malicious
        client's model is corrupted from its own ``noise[client_idx]``, as
        :meth:`apply` corrupts slot ``client_idx`` of the stack, bitwise;
        any other client keeps its trained params. ``client_idx`` is the
        rank, a host int, so the selection is a host branch on the static
        placement (the reference's ``where`` on a traced index)."""
        if client_idx not in self.malicious_set(num_users):
            return params
        bad = self.corrupt(noise[client_idx] if noise is not None else None,
                           params, global_params, ctx, client_idx)
        return tree_map(lambda t, b: b.to(t.dtype), params, bad)

    def __repr__(self) -> str:
        return (f"<attack {self.name} m={self.num_malicious} "
                f"placement={self.placement}>")


class Fault:
    """Per-round client-failure model (DESIGN.md §9), in two parts:

    * ``draw(gen, num_users)`` — the round's random numbers for the fault,
      taken from the round's ``torch.Generator`` (None for a model that
      draws nothing);
    * ``mask(draws, num_users, round_idx, device=None)`` — a pure function
      of those draws giving the ``[N]`` 0/1 f32 survival mask (1: the
      client completes the round), on the draws' device or ``device``.

    The engine ANDs the mask into the participation mask after selection,
    so a dropped client gets the non-sampled semantics: zero weight, a
    frozen score, a masked report row. The parity tests hand ``mask`` the
    reference's ``keys.fault`` draws, so the masks are compared exactly.
    """

    name = "base"

    def draw(self, gen: torch.Generator, num_users: int
             ) -> Optional[torch.Tensor]:
        return None

    def mask(self, draws, num_users: int, round_idx: int,
             device=None) -> torch.Tensor:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<fault {self.name}>"


class Selector:
    """Picks the K tester ids for a round, int32 on the device of ``key``,
    the round's ``torch.Generator`` (the CPU when it is None); ``scores``
    (keyword-only) carries the ``[N]`` moving-average scores entering the
    round. ``round_idx`` is the host int, or a chunk's 0-d int64 device
    counter (``FederatedTrainer.run_chunk``)."""

    name = "base"

    def select(self, key, num_users: int, num_testers: int,
               round_idx, *, scores=None) -> torch.Tensor:
        raise NotImplementedError

    def schedule(self, first_round: int, num_rounds: int, num_users: int,
                 num_testers: int, device) -> None:
        """Before a chunk of ``num_rounds`` rounds from ``first_round``:
        load on ``device`` whatever :meth:`select` reads for them on the
        device counter. Nothing for a policy that needs nothing."""

    def __repr__(self) -> str:
        return f"<selector {self.name}>"


AGGREGATORS = Registry("aggregator")
ATTACKS = Registry("attack")
SELECTORS = Registry("selector")
COALITIONS = Registry("coalition")
FAULTS = Registry("fault")
