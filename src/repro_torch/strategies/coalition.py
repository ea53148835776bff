"""Coalition adversaries: coordinated multi-client attacks (DESIGN.md §7),
counterpart of ``repro/strategies/coalition.py``.

A :class:`Coalition` binds a static member set (placed like an attack's
malicious set: ``size`` + ``placement``, or ``indices``) to up to two
coordinated behaviours:

* a model-space attack, :meth:`Coalition.model_attack`, applied to the
  members in step 3 (``sybil_split`` and ``full_collusion`` split one
  ``scaled_collusion`` poison among them);
* a report-space attack, :meth:`Coalition.transform_reports`, rewriting
  the ``[K, N]`` accuracy matrix after cross-testing (step 5b):
  ``mutual_boost`` has member rows report ``boost_to`` for every member
  and ``deflate_to`` for the ``deflate_top`` top-scoring honest clients.
  The transform is deterministic and runs on the device, with no host
  read.

The engine composes the coalition with ``FedConfig.attack`` through
:meth:`Coalition.compose`: the malicious set becomes the union of the
attack's and the members (so ``malicious_weight`` reports the
coalition's weight), and the coalition's model attack wins on members.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.strategies.base import (
    ATTACKS, Attack, AttackContext, COALITIONS, normalize_placement,
    placement_mask, register, resolve_placement)
from repro_torch.utils import tree_map


class Coalition:
    """A coordinated set of clients. The base class is the inactive
    coalition: its behaviours are the identity."""

    name = "base"

    def __init__(self, *, size: int = 0, placement: str = "last",
                 indices: Optional[Tuple[int, ...]] = None):
        self.size, self.placement, self._indices = normalize_placement(
            size, placement, indices)

    def members(self, num_users: int) -> Tuple[int, ...]:
        """Static member id set (the attacks' placement formula)."""
        return resolve_placement(num_users, self.size, self.placement,
                                 self._indices)

    def member_mask(self, num_users: int, device=None) -> torch.Tensor:
        return placement_mask(num_users, self.members(num_users), device)

    @property
    def active(self) -> bool:
        return self.size > 0

    def model_attack(self) -> Optional[Attack]:
        """Coordinated model-space attack over the members, or None."""
        return None

    def transform_reports(self, key, acc: torch.Tensor,
                          tester_ids: torch.Tensor,
                          ctx: AttackContext) -> torch.Tensor:
        """Report-space attack on the ``[K, N]`` matrix, after honest
        cross-testing and the lying testers; ``ctx`` carries the scores
        entering the round. ``key`` is unused: no coalition draws."""
        return acc

    def compose(self, base_attack: Attack, num_users: int) -> Attack:
        """``base_attack`` when inactive, else the :class:`CoalitionAttack`
        over the union of its malicious set and the members."""
        if not self.active:
            return base_attack
        return CoalitionAttack(self, base_attack, num_users)

    def __repr__(self) -> str:
        return (f"<coalition {self.name} size={self.size} "
                f"placement={self.placement}>")


class CoalitionAttack(Attack):
    """The composed attack seam: coalition members ∪ independent attackers.

    ``corrupt`` routes each client: the coalition's model attack on
    members (when it has one), the base attack on its own malicious set
    otherwise. The dense ``Attack.apply`` hands ``client_idx`` as a host
    int, so the routing is a Python choice; the population tier's
    :meth:`corrupt_slots` routes its slots by ``torch.where``. Members of a report-only
    coalition keep their honest model but count as malicious."""

    name = "coalition"

    def __init__(self, coalition: Coalition, base_attack: Attack,
                 num_users: int):
        self.coalition = coalition
        self.base = base_attack
        self.coal_attack = coalition.model_attack()
        self.num_users = int(num_users)
        self.needs_noise = base_attack.needs_noise
        union = self.malicious_indices(num_users)
        # built once: corrupt() routes every client by membership
        self._members = frozenset(coalition.members(self.num_users))
        self._base_ids = base_attack.malicious_set(self.num_users)
        self.num_malicious = len(union)
        self.scale = base_attack.scale
        self.placement = base_attack.placement
        self._indices = union

    def malicious_indices(self, num_users: int) -> Tuple[int, ...]:
        return tuple(sorted(set(self.base.malicious_indices(num_users))
                            | set(self.coalition.members(num_users))))

    def corrupt(self, key, trained, global_params, ctx=None,
                client_idx=None):
        if self.coal_attack is not None and client_idx in self._members:
            return self.coal_attack.corrupt(key, trained, global_params,
                                            ctx, client_idx)
        if client_idx in self._base_ids:
            return self.base.corrupt(key, trained, global_params, ctx,
                                     client_idx)
        return trained

    def corrupt_slots(self, noise, stack, global_params, ctx, clients,
                      slots):
        """:meth:`corrupt`'s routing on the device: the coalition's model
        attack on a member's slot, the base attack on one of its own
        malicious clients, the trained model elsewhere."""
        def route(mask, corrupted, out):
            keep = mask(self.num_users, clients.device)[clients] > 0
            return tree_map(lambda t, b: torch.where(
                keep.reshape((-1,) + (1,) * (t.dim() - 1)), b.to(t.dtype),
                t), out, corrupted)

        out = stack
        if self._base_ids:
            out = route(self.base.malicious_mask,
                        self.base.corrupt_slots(noise, stack, global_params,
                                                ctx, clients, slots), out)
        if self.coal_attack is not None:
            out = route(self.coalition.member_mask,
                        self.coal_attack.corrupt_slots(
                            noise, stack, global_params, ctx, clients,
                            slots), out)
        return out

    def __repr__(self) -> str:
        return (f"<attack coalition {self.coalition.name} "
                f"base={self.base.name} union={self._indices}>")


@register(COALITIONS, "none")
class NoCoalition(Coalition):
    """No coordination: the independent-adversary default."""

    def members(self, num_users: int) -> Tuple[int, ...]:
        return ()

    @property
    def active(self) -> bool:
        return False


@register(COALITIONS, "mutual_boost")
class MutualBoost(Coalition):
    """Colluding testers boost each other and defame the honest leaders.
    A member's tester row becomes

        A'[k, c] = (1 − m_k) · A[k, c]
                 + m_k · (C_c · boost_to + H_c · deflate_to
                          + (1 − C_c − H_c) · A[k, c])

    with ``m = C[tester_ids]``, ``C`` the member mask and ``H`` the
    ``deflate_top`` highest-scoring honest clients by the scores entering
    the round (``None``: the coalition size; 0: boost only). Ties in the
    scores go to the lower client index, as ``jax.lax.top_k`` breaks
    them."""

    def __init__(self, *, size: int = 0, placement: str = "last",
                 indices: Optional[Tuple[int, ...]] = None,
                 boost_to: float = 1.0, deflate_to: float = 0.0,
                 deflate_top: Optional[int] = None):
        super().__init__(size=size, placement=placement, indices=indices)
        if not 0.0 <= deflate_to <= boost_to <= 1.0:
            raise ValueError(
                f"need 0 <= deflate_to <= boost_to <= 1, got "
                f"deflate_to={deflate_to}, boost_to={boost_to}")
        self.boost_to = float(boost_to)
        self.deflate_to = float(deflate_to)
        if deflate_top is not None and deflate_top < 0:
            raise ValueError(
                f"deflate_top must be >= 0 (0 = boost-only), got "
                f"{deflate_top}")
        self.deflate_top = (None if deflate_top is None
                            else int(deflate_top))

    def transform_reports(self, key, acc, tester_ids, ctx):
        n = acc.shape[1]
        member = self.member_mask(n, acc.device)                 # C [N]
        liar_rows = member[tester_ids.long()] > 0                # m [K]
        top = self.deflate_top if self.deflate_top is not None else self.size
        top = min(top, n)
        lied = acc
        if top > 0:
            # the top-scoring honest clients; members never defame
            # themselves. A stable descending sort puts the lower index
            # first among equal scores
            honest = torch.where(member > 0, -torch.inf, ctx.scores)
            idx = torch.sort(honest, descending=True, stable=True
                             ).indices[:top]
            target = torch.zeros_like(member).index_fill_(0, idx, 1.0)
            lied = torch.where(target[None, :] > 0, self.deflate_to, lied)
        lied = torch.where(member[None, :] > 0, self.boost_to, lied)
        return torch.where(liar_rows[:, None], lied, acc)


class _SybilModelAttack:
    """Mixin: the split-scale coordinated model attack."""

    def model_attack(self) -> Attack:
        return ATTACKS.build(
            "scaled_collusion",
            dict(num_malicious=self.size, placement=self.placement,
                 indices=self._indices, scale=self.scale,
                 split=max(1, self.size)))


@register(COALITIONS, "sybil_split")
class SybilSplit(_SybilModelAttack, Coalition):
    """Sybil-split model poisoning: the members split one sign-flip poison
    of total ``scale`` evenly, each sending ``g − (scale/|C|)·(t − g)``."""

    def __init__(self, *, size: int = 0, placement: str = "last",
                 indices: Optional[Tuple[int, ...]] = None,
                 scale: float = 8.0):
        super().__init__(size=size, placement=placement, indices=indices)
        self.scale = float(scale)


@register(COALITIONS, "full_collusion")
class FullCollusion(_SybilModelAttack, MutualBoost):
    """The combined worst case: sybil-split poisoning and mutual
    boosting at once."""

    def __init__(self, *, size: int = 0, placement: str = "last",
                 indices: Optional[Tuple[int, ...]] = None,
                 scale: float = 8.0, boost_to: float = 1.0,
                 deflate_to: float = 0.0,
                 deflate_top: Optional[int] = None):
        super().__init__(size=size, placement=placement, indices=indices,
                         boost_to=boost_to, deflate_to=deflate_to,
                         deflate_top=deflate_top)
        self.scale = float(scale)
