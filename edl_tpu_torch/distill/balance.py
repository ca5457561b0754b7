"""Client<->teacher assignment: the pure rebalance math (copy of
``edl_tpu.distill.balance``).

Capability of the reference's ``Service.rebalance`` / ``BalanceTable``
(distill/balance_table.py:137-310): with C clients and S servers,

    server_cap = ceil(C / S)        -- max clients one server feeds
    client_cap = max(1, S // C)     -- max servers one client may use

excess links are broken, then clients are greedily linked to the
least-loaded eligible servers; a client's ``version`` bumps exactly when
its server set changes, so heartbeats can return deltas only.

Invariants (property-tested in tests/test_balance.py; the port held against
it in tests/test_torch_discovery.py):

  I1. every server feeds at most ``server_cap`` clients;
  I2. every client holds at most ``client_cap`` servers;
  I3. when S > 0, every client holds exactly ``client_cap`` servers
      (capacity S*ceil(C/S) >= C always suffices);
  I4. server loads are balanced: max(load) - min(load) <= 1 whenever every
      server is eligible for every client — including after joins into a
      long-lived assignment (the skew-repair pass shifts links off the
      most-loaded servers, so a new teacher is put to work immediately
      instead of waiting for client churn);
  I5. versions bump iff the client's server set changed;
  I6. utilization is a TIE-BREAK only: among servers with equal link
      counts the least-busy is preferred — the busy score blends the
      registrar-reported ``util`` with ``queue_depth`` (each queued
      request adds ``QUEUE_WEIGHT``; with a per-class depth split the
      class-specific ``CLASS_QUEUE_WEIGHT`` applies instead, so queued
      HIGH-priority work repels new links hardest), so a backlogged
      teacher sheds new clients before it violates the latency SLO and
      the idle S mod C servers of an under-subscribed service are the
      busiest ones — I1-I4 are unaffected by construction (the link
      count stays the primary key).

Unlike the reference this is a standalone, lock-free-by-construction value
type: the discovery server owns one instance per service and serializes
access; nothing here touches the network or the store.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field


@dataclass
class ClientLinks:
    servers: tuple[str, ...] = ()
    version: int = 0
    last_seen: float = 0.0   # heartbeat bookkeeping (set by the owner)
    meta: dict = dc_field(default_factory=dict)


def caps(n_clients: int, n_servers: int) -> tuple[int, int]:
    """(server_cap, client_cap) for the given population."""
    if n_servers == 0 or n_clients == 0:
        return 0, 0
    server_cap = -(-n_clients // n_servers)          # ceil(C/S)
    client_cap = max(1, n_servers // n_clients)
    return server_cap, client_cap


class ServiceBalance:
    """Assignment state for one service name."""

    # Each queued request adds this much to the busy score: a teacher
    # with 5+ requests backed up loses every tie even against one
    # running flat-out with an empty queue — backlog is the leading
    # indicator of an SLO violation, utilization only the trailing one.
    QUEUE_WEIGHT = 0.2
    # With a per-priority-class depth split (r23 registrars), the same
    # backlog weighs by CLASS: queued high-priority work pressures the
    # tie-break hardest (that backlog is about to breach an SLO), queued
    # low-priority work barely at all (it sheds first under overload
    # anyway). Unknown classes fall back to QUEUE_WEIGHT.
    CLASS_QUEUE_WEIGHT = {"high": 0.4, "normal": 0.2, "low": 0.05}

    def __init__(self, name: str):
        self.name = name
        self.servers: tuple[str, ...] = ()
        self.clients: dict[str, ClientLinks] = {}
        # teacher-reported busy score (registrar stats `util`): ONLY a
        # tie-break among equal link counts, so I1-I4 are untouched —
        # when the population leaves servers idle (S mod C) or several
        # candidates tie, the LEAST-busy teachers get the links
        self.utilization: dict[str, float] = {}
        # reported intake backlog (registrar stats `queue_depth`),
        # blended into the same tie-break: a backlogged teacher sheds
        # NEW clients before it violates the latency SLO
        self.queue_depth: dict[str, int] = {}
        # per-class split of the same backlog (registrar
        # `queue_depth_by_class`): preferred over the flat depth when
        # present
        self.queue_depth_by_class: dict[str, dict[str, int]] = {}

    def set_utilization(self, util: dict[str, float],
                        queue_depth: dict[str, int] | None = None,
                        queue_depth_by_class:
                        dict[str, dict[str, int]] | None = None) -> None:
        self.utilization = dict(util)
        if queue_depth is not None:
            self.queue_depth = dict(queue_depth)
        if queue_depth_by_class is not None:
            self.queue_depth_by_class = dict(queue_depth_by_class)

    def _busy(self, server: str) -> float:
        # Unknown load is NEUTRAL (0.5), not idle: a non-reporting
        # teacher must not systematically win ties against one honestly
        # reporting a small util — it could be saturated for all we know.
        # Queue depth rides on top (unknown = 0: absence of a backlog
        # report must not outweigh a reported idle queue). A by-class
        # split, when reported, replaces the flat term with the
        # class-weighted one.
        by_class = self.queue_depth_by_class.get(server)
        if by_class:
            depth_term = sum(
                self.CLASS_QUEUE_WEIGHT.get(cls, self.QUEUE_WEIGHT) * n
                for cls, n in by_class.items())
        else:
            depth_term = self.QUEUE_WEIGHT * self.queue_depth.get(server, 0)
        return self.utilization.get(server, 0.5) + depth_term

    # -- membership --------------------------------------------------------

    def set_servers(self, servers: list[str]) -> bool:
        """Install the discovered teacher set. Returns True if it changed
        (caller should rebalance)."""
        new = tuple(sorted(set(servers)))
        if new == self.servers:
            return False
        self.servers = new
        return True

    def add_client(self, client_id: str, now: float = 0.0) -> bool:
        """Returns False if already present."""
        if client_id in self.clients:
            self.clients[client_id].last_seen = now
            return False
        self.clients[client_id] = ClientLinks(last_seen=now)
        return True

    def remove_client(self, client_id: str) -> bool:
        return self.clients.pop(client_id, None) is not None

    def touch(self, client_id: str, now: float) -> bool:
        links = self.clients.get(client_id)
        if links is None:
            return False
        links.last_seen = now
        return True

    def expire_clients(self, now: float, ttl: float) -> list[str]:
        """Drop clients whose heartbeat is older than ttl; returns them."""
        dead = [cid for cid, l in self.clients.items()
                if now - l.last_seen > ttl]
        for cid in dead:
            del self.clients[cid]
        return dead

    # -- the rebalance -----------------------------------------------------

    def rebalance(self) -> list[str]:
        """Recompute assignments. Returns the clients whose set changed."""
        server_cap, client_cap = caps(len(self.clients), len(self.servers))
        load = {s: 0 for s in self.servers}
        kept: dict[str, list[str]] = {}

        # Phase 1 — keep existing links that survive caps and membership
        # (minimizes churn: a client keeps its teachers across a rebalance
        # whenever legal).
        for cid in sorted(self.clients):
            links = []
            for s in self.clients[cid].servers:
                if s in load and load[s] < server_cap \
                        and len(links) < client_cap:
                    links.append(s)
                    load[s] += 1
            kept[cid] = links

        # Phase 2 — greedy fill to client_cap from least-loaded servers.
        for cid in sorted(self.clients):
            links = kept[cid]
            while len(links) < client_cap:
                candidates = [s for s in self.servers
                              if load[s] < server_cap and s not in links]
                if not candidates:
                    break
                best = min(candidates,
                           key=lambda s: (load[s], self._busy(s), s))
                links.append(best)
                load[best] += 1

        # Phase 3 — skew repair: without it I4 holds only for fresh
        # assignments — a teacher joining a long-lived service would sit
        # idle until client churn, because phase 1 keeps every legal old
        # link. Shift one link at a time from the most- to the
        # least-loaded server until the gap closes to <= 1.
        if self.servers:
            while True:
                lo = min(self.servers,
                         key=lambda s: (load[s], self._busy(s), s))
                hi = max(self.servers,
                         key=lambda s: (load[s], self._busy(s), s))
                if load[hi] - load[lo] <= 1:
                    break
                moved = False
                for cid in sorted(self.clients):
                    links = kept[cid]
                    if hi in links and lo not in links:
                        links[links.index(hi)] = lo
                        load[hi] -= 1
                        load[lo] += 1
                        moved = True
                        break
                if not moved:
                    break

        changed = []
        for cid, links in kept.items():
            entry = self.clients[cid]
            new = tuple(links)
            if set(new) != set(entry.servers):
                entry.servers = new
                entry.version += 1
                changed.append(cid)
            else:
                entry.servers = new  # order may differ; same set, no bump
        return changed

    # -- reads -------------------------------------------------------------

    def get(self, client_id: str) -> ClientLinks | None:
        return self.clients.get(client_id)

    def loads(self) -> dict[str, int]:
        out = {s: 0 for s in self.servers}
        for links in self.clients.values():
            for s in links.servers:
                if s in out:
                    out[s] += 1
        return out
