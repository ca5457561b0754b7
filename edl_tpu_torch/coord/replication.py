"""Store replication + sharding (copy of ``edl_tpu.coord.replication``;
its peer messages and snapshots are the JAX package's bytes, so a port
replica and a JAX replica speak the same protocol, and either package's
client speaks to either group).

Without it every elastic mechanism (membership, leases, watch streams,
the scaler journal, the donor roster, distill discovery) hangs off ONE
store process. This module removes that single point of failure with
primitives the package already has instead of a consensus library, and
shards discovery across replica groups with a consistent-hash REDIRECT
protocol:

**Replication (one shard group).** A group of ``ReplicaServer``
processes elect a leader with **quorum leases**: the candidate must
hold the lease-backed ``DistributedLock`` (coord/lock.py, unchanged
semantics) on a strict MAJORITY of the group's always-active election
sidecar stores. Two leaders cannot coexist (any two majorities
intersect), leadership is provably live only while a majority of those
leases renews (``held()`` is renewal-age-bounded), and a dead leader
frees the role within one TTL. Each election establishes a
monotonically larger **term**; replication messages carry it and
followers reject lower terms, so a deposed leader's appends bounce off
any member of the new majority: it can never again commit at majority,
and on the first rejection it steps down and marks itself **dirty** (a
deposed leader rejoins via snapshot install, discarding whatever it
applied past the committed point).

The replicated log is the store's OWN revision-stamped mutation
stream: the leader applies a write locally, then per-peer sender
threads ship ``events_since`` deltas (plus lease-grant side entries;
replicated PUTs already carry their lease id, so followers can rebuild
the lease->keys index on promotion) and the write is acknowledged to
the client only once a majority (leader included) has applied its
revision. Followers apply verbatim at the leader's revisions
(``InMemStore.apply_put/apply_delete``, idempotent, so replays after
reconnect dedupe) and therefore serve **reads and watch fan-out**
locally: watches are resumable by revision, so a client that fails
over re-attaches with ``start_revision`` and misses nothing, or sees
an explicit ``compacted`` batch and resyncs. Watch fan-out is
commit-gated, so no watcher ever sees a doomed leader's uncommitted
suffix. Lease EXPIRY stays a leader-only decision (followers are
passive, store.set_passive): it reaches followers as ordinary
replicated DELETE events, and a fresh leader restarts every lease
clock at now+ttl: late expiry is safe, early expiry is not.

This is deliberately NOT Raft: no persistent voted-for state, no
log-divergence reconciliation (dirty nodes take a snapshot instead),
and commit durability is majority-memory, not majority-disk. The
guarantees the elastic machinery consumes (zero lost acked events
across failover, fenced writes, bounded failover time) are checked by
``python -m edl_tpu_torch.coord.replication dryrun``.

**Sharding (many groups).** Registry prefixes shard across replica
groups with the ``ConsistentHash`` ring over group names. ``shard_key``
maps ``/{root}/{service}/...`` to its first two path segments, so one
service's subtree (records, watches, lease-guarded registrations) lands
wholly in one group. A server that does not own a key answers a
structured REDIRECT naming the owning group's endpoints (wire.py),
``StoreClient`` follows it (bounded hops), and ``ShardedStoreClient``
routes directly, materializing leases lazily in the owner group of the
first key that uses them.

CLI: ``python -m edl_tpu_torch.coord.replication serve --endpoint h0:p
--endpoints h0:p,h1:p,h2:p`` runs one replica; ``selftest`` and
``dryrun`` are the logic-level and leader-kill checks. None of it
touches a device.
"""

from __future__ import annotations

import argparse
import json
import random
import socket
import sys
import threading
import time
from collections import deque

from edl_tpu_torch.coord import wire
from edl_tpu_torch.coord.client import StoreClient
from edl_tpu_torch.coord.consistent_hash import ConsistentHash
from edl_tpu_torch.coord.lock import DistributedLock
from edl_tpu_torch.coord.store import Event, InMemStore, Record, Store, Watch
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import recorder as flight
from edl_tpu_torch.utils import config
from edl_tpu_torch.utils.backoff import Backoff
from edl_tpu_torch.utils.exceptions import EdlStoreError
from edl_tpu_torch.utils.logging import get_logger
from edl_tpu_torch.utils.net import split_endpoint

log = get_logger("edl_tpu_torch.coord.replication")

_ELECTION_KEY = "!elect/leader"
_TERM_KEY = "!elect/term"
_WRITE_OPS = frozenset({
    "put", "delete", "delete_prefix", "put_if_absent", "cas",
    "lease_grant", "lease_keepalive", "lease_revoke",
})
_KEY_OPS = frozenset({"put", "get", "delete", "put_if_absent", "cas"})
_PREFIX_OPS = frozenset({"get_prefix", "delete_prefix", "events_since",
                         "watch"})
_SIDE_LOG_MAX = 4096
# leader-side log compaction: once every peer has acked past the floor,
# compact history up to it every _COMPACT_EVERY revisions, keeping a
# _COMPACT_KEEP-event resume cushion for late watch resumers
_COMPACT_EVERY = 2048
_COMPACT_KEEP = 512


def election_ttl_default() -> float:
    """Quorum-lease TTL (seconds): the failover detection horizon — a
    dead leader's locks free within one TTL (EDL_TPU_STORE_ELECTION_TTL)."""
    return max(0.1, config.env_float("EDL_TPU_STORE_ELECTION_TTL", 3.0))


# --------------------------------------------------------------------------
# sharding: key -> group routing


def shard_key(key: str) -> str:
    """The unit of placement: the first two path segments, so one
    service's records/watches/leases co-locate in one replica group
    (``/edl/teachers/nodes/h:1`` -> ``/edl/teachers``)."""
    parts = [p for p in key.split("/") if p]
    if not parts:
        return key
    return "/" + "/".join(parts[:2])


def parse_topology(spec: str, shards: int | None = None
                   ) -> dict[str, list[str]]:
    """Topology from an endpoint spec string.

    - ``"h0:p,h1:p,h2:p"`` — one replica group (name ``shard0``) —
      unless ``EDL_TPU_STORE_SHARDS`` (or ``shards``) asks for k>1
      groups, in which case the flat list is chunked contiguously;
    - ``"h0:p,h1:p;h3:p,h4:p"`` — ``;`` separates groups
      (auto-named ``shard0..shardN``);
    - ``"users=h0:p,h1:p;jobs=h3:p"`` — explicit group names (names are
      the hash-ring identities: keep them stable across resizes or
      every prefix remaps).
    """
    chunks = [c for c in spec.split(";") if c.strip()]
    if len(chunks) == 1 and "=" not in chunks[0]:
        eps = [e.strip() for e in chunks[0].split(",") if e.strip()]
        k = shards if shards is not None \
            else config.env_int("EDL_TPU_STORE_SHARDS", 1)
        if k <= 1 or len(eps) < k:
            return {"shard0": eps}
        per, extra = divmod(len(eps), k)
        groups, at = {}, 0
        for i in range(k):
            size = per + (1 if i < extra else 0)
            groups[f"shard{i}"] = eps[at:at + size]
            at += size
        return groups
    groups = {}
    for i, chunk in enumerate(chunks):
        if "=" in chunk:
            name, _, rest = chunk.partition("=")
        else:
            name, rest = f"shard{i}", chunk
        groups[name.strip()] = [e.strip() for e in rest.split(",")
                                if e.strip()]
    return groups


def topology_spec(groups: dict[str, list[str]]) -> str:
    return ";".join(f"{g}={','.join(eps)}" for g, eps in groups.items())


class ShardRouter:
    """Key/prefix -> owning replica group, over the copy-on-write
    consistent-hash ring (coord/consistent_hash.py)."""

    SPANS = "!spans"  # sentinel: prefix too short to pin one shard

    def __init__(self, groups: dict[str, list[str]]):
        if not groups:
            raise EdlStoreError("empty shard topology")
        self.groups = {g: list(eps) for g, eps in groups.items()}
        self._single = next(iter(groups)) if len(groups) == 1 else None
        self._ring = None if self._single else ConsistentHash(list(groups))

    def owner(self, key: str) -> str:
        if self._single is not None:
            return self._single
        return self._ring.lookup(shard_key(key))

    def owner_of_prefix(self, prefix: str) -> str:
        """Owning group for a prefix, or ``SPANS`` when the prefix pins
        fewer than two path segments (it could cover several shards)."""
        if self._single is not None:
            return self._single
        if len([p for p in prefix.split("/") if p]) < 2:
            return self.SPANS
        return self._ring.lookup(shard_key(prefix))

    def endpoints(self, group: str) -> list[str]:
        return self.groups[group]

    def route(self, op: str, req: dict) -> str | None:
        """Owning group for a request: a group name, ``SPANS``, or None
        for ops with no placement (lease ops are leader-local to
        whichever group the client routed them to)."""
        if op in _KEY_OPS:
            return self.owner(req.get("key", ""))
        if op in _PREFIX_OPS:
            return self.owner_of_prefix(req.get("prefix", ""))
        return None


# --------------------------------------------------------------------------
# quorum lease: leadership = DistributedLock held on a majority


class _ElectClient(StoreClient):
    """StoreClient whose every request routes to the peer's ALWAYS-ACTIVE
    election sidecar store (``elect_space`` flag, wire.py) — the
    election substrate must keep granting/expiring leases while the
    data store is a passive follower. Short budgets: an unreachable
    peer must fail a campaign round fast, not after the data client's
    patient 30-round schedule."""

    def __init__(self, node: "ReplicaNode", endpoint: str, ttl: float):
        self._node = node
        self._peer = endpoint
        super().__init__(endpoint, timeout=max(0.2, min(1.0, ttl / 2.0)),
                         connect_retries=1, retry_interval=0.05)

    def _call(self, **req) -> dict:
        if self._node._blocked(self._peer):
            raise EdlStoreError("partitioned (chaos hook)")
        req["elect_space"] = True
        return super()._call(**req)


class QuorumLease:
    """Leadership as a majority of lease-backed locks.

    One ``DistributedLock`` per group member (the member's own sidecar
    in-process, peers over ``_ElectClient``); acquisition wins only
    with a strict majority and releases partial wins immediately.
    ``held()`` is the fencing check: True only while a majority of the
    underlying leases is PROVABLY live (each lock bounds its answer by
    its last confirmed renewal's age — coord/lock.py)."""

    def __init__(self, node: "ReplicaNode"):
        self._node = node
        self.majority = node.majority
        self.locks: list[DistributedLock] = []
        for ep in node.group_endpoints:
            store = node.elect if ep == node.endpoint \
                else node._elect_client(ep)
            self.locks.append(DistributedLock(
                store, _ELECTION_KEY, node.endpoint,
                ttl=node.election_ttl))

    def try_acquire(self) -> bool:
        wins = 0
        for lock in self.locks:
            try:
                if lock.try_acquire():
                    wins += 1
            except (EdlStoreError, ConnectionError, OSError):
                pass  # unreachable member counts as a lost vote
        if wins >= self.majority:
            return True
        self.release()
        return False

    def held(self) -> bool:
        return sum(1 for lock in self.locks if lock.held()) >= self.majority

    def release(self) -> None:
        for lock in self.locks:
            try:
                lock.release()
            except (EdlStoreError, ConnectionError, OSError):
                pass

    def abandon(self) -> None:
        """Crash simulation: stop keepalives WITHOUT revoking, so the
        role frees only when the TTLs run out — chaos tests pay the
        real failover price."""
        for lock in self.locks:
            lock.abandon()


# --------------------------------------------------------------------------
# the replica node


class ReplicaNode:
    """Replication/routing brain of one store replica.

    Owns the replicated data store (``self.store``, passive while
    follower), the election sidecar (``self.elect``, always active),
    the elector thread and one sender thread per peer. Plugged into
    ``StoreServer`` via ``intercept`` (coord/server.py calls it for
    every request before local dispatch).
    """

    def __init__(self, endpoint: str, group_endpoints: list[str], *,
                 group: str = "shard0",
                 topology: dict[str, list[str]] | None = None,
                 store: InMemStore | None = None,
                 election_ttl: float | None = None,
                 heartbeat: float | None = None,
                 commit_timeout: float = 5.0,
                 rng: random.Random | None = None):
        if endpoint not in group_endpoints:
            raise EdlStoreError(
                f"replica endpoint {endpoint!r} missing from its own "
                f"group {group_endpoints!r}")
        self.endpoint = endpoint
        self.group = group
        self.group_endpoints = list(group_endpoints)
        self.peers = [e for e in group_endpoints if e != endpoint]
        self.majority = len(self.group_endpoints) // 2 + 1
        self.store = store or InMemStore()
        self.elect = InMemStore()
        self.router = ShardRouter(topology) \
            if topology and len(topology) > 1 else None
        self.election_ttl = election_ttl if election_ttl is not None \
            else election_ttl_default()
        self.heartbeat = heartbeat if heartbeat is not None \
            else max(0.05, min(0.25, self.election_ttl / 8.0))
        self.commit_timeout = commit_timeout
        self._rng = rng or random.Random()

        self._state_lock = threading.Lock()
        self._role = "follower"            # guarded-by: _state_lock
        self._term = 0                     # guarded-by: _state_lock
        self._leader_endpoint: str | None = None  # guarded-by: _state_lock
        self._last_leader_contact = 0.0    # guarded-by: _state_lock
        # deposed-leader marker: state past the commit point may
        # diverge — rejoin via snapshot, not incremental append
        self._dirty = False                # guarded-by: _state_lock

        self._commit_cond = threading.Condition()
        self._commit_rev = 0               # guarded-by: _commit_cond
        self._match: dict[str, int] = {}   # guarded-by: _commit_cond
        # this reign's baseline: the local revision at promotion. A
        # clean peer first met in the reign above it holds a suffix
        # this leader never wrote (see _sender_loop).
        self._reign_base = 0               # guarded-by: _commit_cond

        self._side_lock = threading.Lock()
        # lease-grant/revoke side entries: (seq, pos, wire entry) — the
        # event log carries everything else (PUT events carry lease ids)
        self._side: deque = deque(maxlen=_SIDE_LOG_MAX)  # guarded-by: _side_lock
        self._side_seq = 0                 # guarded-by: _side_lock

        self._wake_cond = threading.Condition()
        self._pending: dict[str, bool] = {p: False for p in self.peers}  # guarded-by: _wake_cond

        self._elect_clients: dict[str, _ElectClient] = {}
        # Chaos partition hook: False = healthy, True = severed from ALL
        # peers (the asymmetric partition: clients still reach this
        # node's server socket, but it cannot reach quorum), or a
        # frozenset of peer endpoints to sever selectively. Inbound
        # peer traffic from a severed endpoint is refused too, so a
        # partition is symmetric per-link.
        self._partition: frozenset[str] | bool = False
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # election-churn counters (the obs registry's replica view; the
        # flight recorder keeps the per-transition event detail)
        self._elections_won = 0            # guarded-by: _state_lock
        self._step_downs = 0               # guarded-by: _state_lock
        self._snapshot_installs = 0        # guarded-by: _state_lock
        self._delta_installs = 0           # guarded-by: _state_lock
        # leader-side log compaction floor (last revision compacted to)
        self._compact_floor = 0            # guarded-by: _commit_cond
        self._obs = obs_metrics.register_stats("replica", self.stats)
        self.store.set_passive(True)
        # Commit-gated watch fan-out: a replicated store's watchers
        # (local AND wire-served, leader AND follower) only ever see
        # events at or below the majority-committed revision — a doomed
        # leader's uncommitted suffix is buffered, then discarded by the
        # snapshot rejoin, so no watcher can observe revisions a new
        # reign will reuse.
        self.store.set_fanout_gate(True)
        self.quorum = QuorumLease(self)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ReplicaNode":
        elector = threading.Thread(target=self._elector, daemon=True,
                                   name=f"repl-elect-{self.endpoint}")
        self._threads = [elector]
        for peer in self.peers:
            t = threading.Thread(target=self._sender_loop, args=(peer,),
                                 daemon=True,
                                 name=f"repl-send-{self.endpoint}->{peer}")
            self._threads.append(t)
        for t in self._threads:
            t.start()
        return self

    def stats(self) -> dict:
        """Replica counters as a dict view (registered into the obs
        registry at construction): role/term plus election churn, the
        numbers a scrape reads."""
        with self._state_lock:
            return {"role": self._role, "term": self._term,
                    "dirty": self._dirty,
                    "is_leader": self._role == "leader",
                    "elections_won": self._elections_won,
                    "step_downs": self._step_downs,
                    "snapshot_installs": self._snapshot_installs,
                    "delta_installs": self._delta_installs,
                    "peers": len(self.peers)}

    def stop(self, graceful: bool = True) -> None:
        """Graceful stop resigns (successors campaign immediately);
        ``graceful=False`` simulates a crash — locks stay until TTL."""
        obs_metrics.unregister(self._obs)
        self._stop.set()
        with self._wake_cond:
            self._wake_cond.notify_all()
        with self._commit_cond:
            self._commit_cond.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)
        if graceful:
            self.quorum.release()
        else:
            self.quorum.abandon()
        for client in self._elect_clients.values():
            client.close()

    def kill(self) -> None:
        self.stop(graceful=False)

    # -- chaos partition hook ------------------------------------------------

    def set_partition(self, peers: bool | list[str] | None) -> None:
        """Sever (or heal, with None/False) this node's peer links:
        True drops traffic to/from every peer, a list severs only those
        endpoints. Client connections to this node's own server socket
        are untouched — combining ``set_partition(True)`` on a leader
        with a client pinned to it is the asymmetric partition drill
        (reachable deposed leader, unreachable quorum)."""
        if peers is None or peers is False:
            self._partition = False
        elif peers is True:
            self._partition = True
        else:
            self._partition = frozenset(peers)

    def _blocked(self, peer: str | None) -> bool:
        part = self._partition
        if part is False:
            return False
        if part is True:
            return True
        return peer is not None and peer in part

    # Legacy chaos hook spelling (tests set it directly): truthiness
    # maps onto the all-peers partition.
    @property
    def _partitioned(self) -> bool:
        return bool(self._partition)

    @_partitioned.setter
    def _partitioned(self, value: bool) -> None:
        self.set_partition(bool(value))

    def sweep(self) -> None:
        """Called by the hosting StoreServer's sweeper: the election
        sidecar expires leases even while the data store is passive.
        A leader also advances the commit gate here — the net that
        releases lease-expiry DELETEs (and single-replica groups, which
        have no sender acks) to watchers on a bounded cadence."""
        self.elect.sweep()
        if self.role() == "leader":
            self._advance_fanout()

    def _elect_client(self, endpoint: str) -> _ElectClient:
        client = self._elect_clients.get(endpoint)
        if client is None:
            client = _ElectClient(self, endpoint, self.election_ttl)
            self._elect_clients[endpoint] = client
        return client

    # -- role/introspection -------------------------------------------------

    def role(self) -> str:
        with self._state_lock:
            return self._role

    def term(self) -> int:
        with self._state_lock:
            return self._term

    def leader_endpoint(self) -> str | None:
        with self._state_lock:
            if self._role == "leader":
                return self.endpoint
            # a hint older than the election horizon is worse than no
            # hint: during failover it names the DEAD leader and sends
            # clients chasing a corpse instead of backing off for the
            # new one
            if time.monotonic() - self._last_leader_contact \
                    > self.election_ttl:
                return None
            return self._leader_endpoint

    def is_leader(self) -> bool:
        """Lease-fenced: role alone is a hint; the quorum lease must be
        provably live. Consulted before every acknowledged write."""
        return self.role() == "leader" and self.quorum.held()

    def status_doc(self) -> dict:
        with self._state_lock:
            role, term, dirty = self._role, self._term, self._dirty
        leader = self.leader_endpoint()
        return {"ok": True, "role": role, "term": term, "leader": leader,
                "revision": self.store.current_revision,
                "group": self.group, "endpoints": self.group_endpoints,
                "dirty": dirty, "commit": self.commit_revision()}

    def commit_revision(self) -> int:
        with self._commit_cond:
            return self._commit_rev

    # -- election -----------------------------------------------------------

    def _elector(self) -> None:
        campaign_backoff = Backoff(base=self.election_ttl / 4.0,
                                   max_delay=self.election_ttl,
                                   rng=self._rng)
        while not self._stop.is_set():
            if self.role() == "leader":
                if not self.quorum.held():
                    self.step_down("quorum lease lost")
                elif self._stop.wait(max(0.02, self.election_ttl / 8.0)):
                    return
                continue
            with self._state_lock:
                age = time.monotonic() - self._last_leader_contact
            if age < self.election_ttl:
                # a live leader is appending/heartbeating — no campaign
                if self._stop.wait(max(0.02, self.election_ttl / 4.0)):
                    return
                continue
            if self._peer_ahead():
                # election restriction: a reachable peer with a higher
                # revision holds committed state we might not — defer,
                # let it win (combined with majority-ack writes this is
                # what preserves acked events across leader death)
                if campaign_backoff.sleep(self._stop):
                    return
                continue
            if self.quorum.try_acquire():
                # ask again under the lease: the last reign could still
                # ack writes until its own lease lapsed on a majority
                if self._peer_ahead():
                    self.quorum.release()
                    if campaign_backoff.sleep(self._stop):
                        return
                    continue
                self._become_leader()
                campaign_backoff.reset()
            elif campaign_backoff.sleep(self._stop):
                return

    def _peer_ahead(self) -> bool:
        """Whether this campaign must defer. An acked write lives on a
        majority, so a candidate that hears from a majority (itself
        included) meets at least one holder of every acked write: it
        defers when too few peers answer to show that, or when one that
        answers may hold acked writes it lacks — a clean peer with a
        higher revision, or a dirty one whose commit point is above it
        (the revisions past a dirty peer's commit point may be a
        deposed reign's suffix and do not count)."""
        mine = self.store.current_revision
        answered = 1
        for peer in self.peers:
            try:
                resp = self._peer_call(peer, {"op": "status"},
                                       timeout=max(0.2, self.election_ttl / 4))
            except (EdlStoreError, OSError, wire.WireError):
                continue
            answered += 1
            seen = int(resp.get("commit", 0)) if resp.get("dirty") \
                else int(resp.get("revision", 0))
            if seen > mine:
                return True
        return answered < self.majority

    def _become_leader(self) -> None:
        # Establish the fencing term: strictly above every term any
        # reachable member has seen. Persisted in the election sidecars
        # so the NEXT winner reads past this reign even if we crash.
        terms = [self._read_term(self.elect)]
        with self._state_lock:
            terms.append(self._term)
        for peer in self.peers:
            try:
                terms.append(self._read_term(self._elect_client(peer)))
            except (EdlStoreError, ConnectionError, OSError):
                pass
        new_term = max(terms) + 1
        try:
            self.elect.put(_TERM_KEY, str(new_term))
        except EdlStoreError:
            pass
        for peer in self.peers:
            try:
                self._elect_client(peer).put(_TERM_KEY, str(new_term))
            except (EdlStoreError, ConnectionError, OSError):
                pass
        with self._state_lock:
            self._role = "leader"
            self._term = new_term
            self._leader_endpoint = self.endpoint
            self._last_leader_contact = time.monotonic()
            self._dirty = False
            self._elections_won += 1
        flight.record("election", replica=self.endpoint, group=self.group,
                      term=new_term, won=True)
        # active mode: resume lease-expiry duty; every lease clock
        # restarts at now+ttl (late expiry is safe, early is not)
        self.store.set_passive(False)
        # a new reign's local log IS the committed baseline (divergent
        # peers rejoin via snapshot): open the fan-out gate up to it
        self.store.release_fanout(self.store.current_revision)
        with self._commit_cond:
            self._match = {}
            self._reign_base = self.store.current_revision
            self._recompute_commit_locked()
        self.notify_senders()
        log.info("replica %s is LEADER of %s (term %d, revision %d)",
                 self.endpoint, self.group, new_term,
                 self.store.current_revision)

    @staticmethod
    def _read_term(store: Store) -> int:
        rec = store.get(_TERM_KEY)
        try:
            return int(rec.value) if rec is not None else 0
        except ValueError:
            return 0

    def step_down(self, reason: str, new_term: int | None = None) -> None:
        with self._state_lock:
            was_leader = self._role == "leader"
            self._role = "follower"
            if new_term is not None and new_term > self._term:
                self._term = new_term
            if was_leader:
                self._leader_endpoint = None
                self._dirty = True
                self._step_downs += 1
            term = self._term
        if was_leader:
            self.store.set_passive(True)
            flight.record("failover", replica=self.endpoint,
                          group=self.group, term=term, reason=reason)
            log.warning("replica %s deposed (%s) — dirty until snapshot "
                        "rejoin", self.endpoint, reason)
        self.quorum.release()
        with self._commit_cond:
            self._commit_cond.notify_all()  # waiters re-check role, fail fast

    # -- leader: log shipping ----------------------------------------------

    def _append_side(self, entry: list) -> None:
        with self._side_lock:
            self._side_seq += 1
            self._side.append((self._side_seq, self.store.current_revision,
                               entry))

    def _entries_since(self, rev: int, side_seq: int):
        """(entries, side_seq') covering everything a follower at
        ``rev`` is missing, or None when the event history no longer
        reaches back that far (caller ships a snapshot instead)."""
        evs, _cur, compacted = self.store.events_since(rev)
        if compacted:
            return None
        entries: list[tuple] = []
        for ev in evs:
            lease = 0
            if ev.type == "PUT":
                rec = self.store.get(ev.key)
                if rec is not None and rec.revision == ev.revision:
                    lease = rec.lease
            entries.append(((ev.revision, 0),
                            ["EV", ev.type, ev.key, ev.value, ev.revision,
                             lease]))
        new_seq = side_seq
        with self._side_lock:
            for seq, pos, entry in self._side:
                if seq > side_seq:
                    entries.append(((pos, 1), entry))
                    new_seq = max(new_seq, seq)
        entries.sort(key=lambda pair: pair[0])
        return [e for _, e in entries], new_seq

    def notify_senders(self) -> None:
        with self._wake_cond:
            for peer in self._pending:
                self._pending[peer] = True
            self._wake_cond.notify_all()

    def _update_match(self, peer: str, rev: int) -> None:
        with self._commit_cond:
            self._match[peer] = max(self._match.get(peer, 0), rev)
            self._recompute_commit_locked()
            commit = self._commit_rev
            # log-compaction floor: the lowest revision ANY peer has
            # acked — history below it only serves late watch resumers
            floor = min((self._match.get(p, 0) for p in self.peers),
                        default=commit)
            floor = min(floor, commit)
            compact_to = 0
            if floor - self._compact_floor >= _COMPACT_EVERY:
                self._compact_floor = compact_to = floor
        # commit advanced (or held): release watch fan-out up to it —
        # outside the condition so the lock order stays commit_cond ->
        # store lock in one direction only
        self.store.release_fanout(commit)
        if compact_to:
            dropped = self.store.compact(compact_to, keep=_COMPACT_KEEP)
            if dropped:
                log.debug("leader %s compacted %d events (<= rev %d)",
                          self.endpoint, dropped, compact_to)

    def _advance_fanout(self) -> None:
        """Recompute the commit point and release watch fan-out to it."""
        with self._commit_cond:
            self._recompute_commit_locked()
            commit = self._commit_rev
        self.store.release_fanout(commit)

    def _recompute_commit_locked(self) -> None:  # holds-lock: _commit_cond
        revs = [self.store.current_revision]
        revs += [self._match.get(p, -1) for p in self.peers]
        revs.sort(reverse=True)
        commit = revs[self.majority - 1]
        if commit > self._commit_rev:
            self._commit_rev = commit
            self._commit_cond.notify_all()

    def _wait_commit(self, rev: int) -> bool:
        deadline = time.monotonic() + self.commit_timeout
        with self._commit_cond:
            self._recompute_commit_locked()
            while self._commit_rev < rev:
                if self._stop.is_set() or not self.is_leader():
                    return False
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._commit_cond.wait(min(remaining, 0.1))
            return True

    def _sender_loop(self, peer: str) -> None:
        sock: socket.socket | None = None
        peer_rev: int | None = None  # None: probe before next append
        side_seq = 0
        synced_term = 0  # the term in which this peer was last probed
        last_send = 0.0
        backoff = Backoff(base=max(0.02, self.heartbeat / 2.0),
                          max_delay=min(1.0, self.election_ttl),
                          rng=self._rng)

        def _drop() -> None:
            nonlocal sock, peer_rev
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            sock, peer_rev = None, None

        while not self._stop.is_set():
            with self._wake_cond:
                if not self._pending.get(peer):
                    self._wake_cond.wait(self.heartbeat)
                self._pending[peer] = False
            if self._stop.is_set():
                break
            if self.role() != "leader" or self._blocked(peer):
                _drop()
                continue
            try:
                if sock is None:
                    sock = socket.create_connection(
                        split_endpoint(peer),
                        timeout=max(0.5, self.election_ttl))
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                term = self.term()
                if peer_rev is None:
                    resp = self._roundtrip(sock, {
                        "op": "repl_probe", "term": term,
                        "leader": self.endpoint})
                    if self._check_stale(resp):
                        _drop()
                        continue
                    peer_rev = int(resp["revision"])
                    if resp.get("dirty") or self._diverged(
                            peer_rev, first=synced_term != term):
                        peer_rev, side_seq = self._send_snapshot(sock, term)
                    else:
                        side_seq = 0
                    synced_term = term
                    self._update_match(peer, peer_rev)
                got = self._entries_since(peer_rev, side_seq)
                if got is None:
                    peer_rev, side_seq = self._send_snapshot(sock, term)
                    self._update_match(peer, peer_rev)
                else:
                    entries, new_seq = got
                    due = time.monotonic() - last_send >= self.heartbeat
                    if entries or due:
                        resp = self._roundtrip(sock, {
                            "op": "repl_append", "term": term,
                            "leader": self.endpoint,
                            "commit": self.commit_revision(),
                            "entries": entries})
                        if self._check_stale(resp):
                            _drop()
                            continue
                        if not resp.get("ok"):
                            raise EdlStoreError(str(resp.get("error")))
                        peer_rev = int(resp["revision"])
                        side_seq = new_seq
                        last_send = time.monotonic()
                        self._update_match(peer, peer_rev)
                backoff.reset()
            except (OSError, wire.WireError, EdlStoreError, KeyError,
                    TypeError, ValueError) as exc:
                log.debug("sender %s->%s error: %s", self.endpoint, peer,
                          exc)
                _drop()
                if backoff.sleep(self._stop):
                    return

    def _diverged(self, peer_rev: int, first: bool) -> bool:
        """A clean peer's revision that this leader's log cannot account
        for: above the local revision, or, at the first probe of this
        reign, above the reign's baseline (a suffix from an earlier
        reign, which was never acked). Counting it as matched would
        commit this reign's writes at revisions the peer skips as
        replays; a snapshot brings it back to this log."""
        with self._commit_cond:
            base = self._reign_base
        return peer_rev > self.store.current_revision \
            or (first and peer_rev > base)

    def _send_snapshot(self, sock: socket.socket, term: int
                       ) -> tuple[int, int]:
        """Ship catch-up state: delta-compressed against the peer's
        digest when it answers one (only divergent/missing records
        cross the wire — fast rejoin for a briefly-dirty ex-leader
        whose keyspace is 99% identical), full state otherwise."""
        msg: dict = {"op": "repl_snapshot", "term": term,
                     "leader": self.endpoint}
        revision = None
        try:
            dig = self._roundtrip(sock, {
                "op": "repl_digest", "term": term, "leader": self.endpoint})
            if self._check_stale(dig):
                raise EdlStoreError("deposed during digest exchange")
            if dig.get("ok") and dig.get("digest") is not None:
                delta = self.store.snapshot_delta(dig["digest"])
                msg["delta"] = delta
                revision = int(delta["revision"])
        except (KeyError, TypeError, ValueError):
            pass  # malformed digest: fall through to a full snapshot
        if revision is None:
            state = self.store.snapshot_state()
            msg["state"] = state
            revision = int(state["revision"])
        resp = self._roundtrip(sock, msg)
        if self._check_stale(resp):
            raise EdlStoreError("deposed during snapshot install")
        if not resp.get("ok"):
            raise EdlStoreError(str(resp.get("error")))
        with self._side_lock:
            seq = self._side_seq
        return revision, seq

    def _check_stale(self, resp: dict) -> bool:
        if resp.get("stale_term"):
            self.step_down("rejected by higher term "
                           f"{resp.get('term')}",
                           new_term=int(resp.get("term") or 0))
            return True
        return False

    @staticmethod
    def _roundtrip(sock: socket.socket, msg: dict) -> dict:
        wire.send_msg(sock, msg)
        return wire.recv_msg(sock)

    def _peer_call(self, endpoint: str, msg: dict, timeout: float) -> dict:
        if self._blocked(endpoint):
            raise EdlStoreError("partitioned (chaos hook)")
        sock = socket.create_connection(split_endpoint(endpoint),
                                        timeout=timeout)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return self._roundtrip(sock, msg)
        finally:
            try:
                sock.close()
            except OSError:
                pass

    # -- follower: applying the log -----------------------------------------

    def _accept_leader(self, term: int, leader: str) -> dict | None:
        """Term gate for every peer message; None accepts, a dict is
        the stale-term rejection to send back (the fencing half of the
        split-brain rule — the deposed leader reads it and kills its
        own leadership)."""
        step_down_reason = None
        with self._state_lock:
            if term < self._term or (term == self._term
                                     and self._role == "leader"
                                     and leader != self.endpoint):
                return {"ok": False, "stale_term": True, "term": self._term,
                        "error": f"stale term {term} < {self._term}"}
            if self._role == "leader" and leader != self.endpoint:
                step_down_reason = f"saw leader {leader} at term {term}"
            else:
                self._term = max(self._term, term)
                self._leader_endpoint = leader
                self._last_leader_contact = time.monotonic()
        if step_down_reason is not None:
            self.step_down(step_down_reason, new_term=term)
            with self._state_lock:
                self._leader_endpoint = leader
                self._last_leader_contact = time.monotonic()
        return None

    def _handle_probe(self, req: dict) -> dict:
        rejection = self._accept_leader(int(req.get("term", 0)),
                                        str(req.get("leader", "")))
        if rejection is not None:
            return rejection
        with self._state_lock:
            dirty = self._dirty
        return {"ok": True, "revision": self.store.current_revision,
                "dirty": dirty, "term": self.term()}

    def _handle_append(self, req: dict) -> dict:
        rejection = self._accept_leader(int(req.get("term", 0)),
                                        str(req.get("leader", "")))
        if rejection is not None:
            return rejection
        for entry in req.get("entries", ()):
            kind = entry[0]
            if kind == "EV":
                _, typ, key, value, rev, lease = entry
                if typ == "PUT":
                    self.store.apply_put(key, value, int(rev),
                                         int(lease or 0))
                else:
                    self.store.apply_delete(key, value, int(rev))
            elif kind == "LEASE":
                self.store.apply_lease(int(entry[1]), float(entry[2]))
            elif kind == "LEASE_GONE":
                self.store.apply_lease_gone(int(entry[1]))
        # follower-side commit gate: the leader's append carries its
        # commit point; everything at or below it is safe to fan out
        # (release_fanout clamps to what was actually applied here)
        self.store.release_fanout(int(req.get("commit", 0)))
        return {"ok": True, "revision": self.store.current_revision,
                "term": self.term()}

    def _handle_digest(self, req: dict) -> dict:
        rejection = self._accept_leader(int(req.get("term", 0)),
                                        str(req.get("leader", "")))
        if rejection is not None:
            return rejection
        return {"ok": True, "digest": self.store.state_digest(),
                "term": self.term()}

    def _handle_snapshot(self, req: dict) -> dict:
        rejection = self._accept_leader(int(req.get("term", 0)),
                                        str(req.get("leader", "")))
        if rejection is not None:
            return rejection
        delta = req.get("delta")
        if delta is not None:
            self.store.install_snapshot_delta(delta)
        else:
            self.store.install_snapshot(req.get("state") or {})
        with self._state_lock:
            self._dirty = False
            self._snapshot_installs += 1
            if delta is not None:
                self._delta_installs += 1
        flight.record("snapshot_install", replica=self.endpoint,
                      group=self.group, delta=delta is not None,
                      revision=self.store.current_revision)
        log.info("replica %s installed %s snapshot at revision %d",
                 self.endpoint, "delta" if delta is not None else "full",
                 self.store.current_revision)
        return {"ok": True, "revision": self.store.current_revision,
                "term": self.term()}

    # -- the server hook ----------------------------------------------------

    def intercept(self, req: dict) -> dict | None:
        """Routing for one request; None means 'serve from the local
        store' (reads and watches on ANY role — followers serve watch
        fan-out — and everything on a clean leader)."""
        from edl_tpu_torch.coord.server import _Handler
        op = req.get("op")
        if req.get("elect_space"):
            sub = {k: v for k, v in req.items() if k != "elect_space"}
            if op == "watch" or op.startswith("repl_"):
                return {"ok": False,
                        "error": f"op {op!r} unsupported in elect space"}
            return _Handler._dispatch(self.elect, sub)
        if op in ("repl_probe", "repl_append", "repl_digest",
                  "repl_snapshot"):
            if self._blocked(str(req.get("leader") or "") or None):
                return {"ok": False, "error": "partitioned (chaos hook)"}
            if op == "repl_probe":
                return self._handle_probe(req)
            if op == "repl_append":
                return self._handle_append(req)
            if op == "repl_digest":
                return self._handle_digest(req)
            return self._handle_snapshot(req)
        if op == "status":
            return self.status_doc()
        if self.router is not None:
            owner = self.router.route(op, req)
            if owner == ShardRouter.SPANS:
                return {"ok": False, "error":
                        "EdlStoreError: prefix spans shard groups — "
                        "scope reads/watches to /{root}/{service}/ in "
                        "a sharded topology"}
            if owner is not None and owner != self.group:
                return {"ok": False, "redirect": True, "group": owner,
                        "endpoints": self.router.endpoints(owner),
                        "error": f"key owned by shard group {owner!r}"}
        if op in _WRITE_OPS:
            return self._leader_write(req)
        return None  # reads/watch: local store, any role

    def _leader_write(self, req: dict) -> dict:
        from edl_tpu_torch.coord.server import _Handler
        if not self.is_leader():
            return {"ok": False, "not_leader": True,
                    "leader": self.leader_endpoint(),
                    "error": "EdlStoreError: not the leader"}
        op = req.get("op")
        resp = _Handler._dispatch(self.store, req)
        if not resp.get("ok"):
            return resp
        if op == "lease_grant":
            self._append_side(["LEASE", resp["lease"], float(req["ttl"])])
            self.notify_senders()
            return resp  # grant metadata: majority wait not required
        if op == "lease_keepalive":
            return resp  # leader-local; promotion re-bases deadlines
        if op == "lease_revoke":
            self._append_side(["LEASE_GONE", req["lease"]])
        rev = self.store.current_revision
        self.notify_senders()
        # Fencing + durability gate: acked == applied at majority. On
        # timeout the local apply may still replicate later — the same
        # ambiguity etcd surfaces on a commit timeout — so the error
        # says so instead of pretending the write vanished.
        if not self._wait_commit(rev):
            # NOT released to watchers: the suffix stays behind the
            # commit gate — it either commits later (a sender ack
            # releases it) or dies with this reign (snapshot rejoin
            # discards it), so no watcher ever saw the ambiguity
            return {"ok": False, "error":
                    "EdlStoreError: replication commit timeout — write "
                    "not acknowledged at majority (may still commit)"}
        self.store.release_fanout(rev)
        return resp


# --------------------------------------------------------------------------
# one process-worth of replica: server + node


class ReplicaServer:
    """One store replica: a ``StoreServer`` (TCP, watch streams, lease
    sweeper) with a ``ReplicaNode`` plugged into its request path."""

    def __init__(self, endpoint: str, port: int, *, host: str = "127.0.0.1",
                 group_endpoints: list[str],
                 group: str = "shard0",
                 topology: dict[str, list[str]] | None = None,
                 election_ttl: float | None = None,
                 sweep_interval: float = 0.25,
                 **node_kw):
        from edl_tpu_torch.coord.server import StoreServer
        self.endpoint = endpoint
        self.node = ReplicaNode(endpoint, group_endpoints, group=group,
                                topology=topology,
                                election_ttl=election_ttl, **node_kw)
        self.server = StoreServer(port=port, host=host,
                                  store=self.node.store,
                                  sweep_interval=sweep_interval,
                                  node=self.node)
        self.port = self.server.port

    def start(self) -> "ReplicaServer":
        self.server.start()
        self.node.start()
        return self

    def stop(self) -> None:
        self.node.stop(graceful=True)
        self.server.stop()

    def kill(self) -> None:
        """Crash: no resign, no graceful anything — peers pay the full
        lease-expiry price to take over (what the chaos tests measure)."""
        self.node.kill()
        self.server.stop()

    def __enter__(self) -> "ReplicaServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class ReplicaGroup:
    """In-process N-replica group (tests and the dryrun)."""

    def __init__(self, n: int = 3, *, host: str = "127.0.0.1",
                 election_ttl: float = 0.6,
                 topology: dict[str, list[str]] | None = None,
                 group: str = "shard0", **node_kw):
        from edl_tpu_torch.utils.net import free_port
        ports = [free_port() for _ in range(n)]
        self.endpoints = [f"{host}:{p}" for p in ports]
        self.servers = [
            ReplicaServer(self.endpoints[i], ports[i], host=host,
                          group_endpoints=self.endpoints, group=group,
                          topology=topology, election_ttl=election_ttl,
                          **node_kw)
            for i in range(n)
        ]

    @property
    def endpoints_spec(self) -> str:
        return ",".join(ep for ep, srv in zip(self.endpoints, self.servers)
                        if srv is not None)

    def start(self) -> "ReplicaGroup":
        for srv in self.servers:
            if srv is not None:
                srv.start()
        return self

    def leader(self) -> ReplicaServer | None:
        for srv in self.servers:
            if srv is not None and srv.node.is_leader():
                return srv
        return None

    def wait_leader(self, timeout: float = 15.0) -> ReplicaServer:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            srv = self.leader()
            if srv is not None:
                return srv
            time.sleep(0.02)
        raise EdlStoreError("no leader elected within "
                            f"{timeout}s among {self.endpoints}")

    def kill_leader(self) -> str:
        """Crash the current leader; returns its endpoint. The server
        slot becomes None — the group runs degraded, like production."""
        srv = self.wait_leader()
        srv.kill()
        self.servers[self.servers.index(srv)] = None
        return srv.endpoint

    def client(self, **kw) -> StoreClient:
        return StoreClient(self.endpoints_spec, **kw)

    def stop(self) -> None:
        for srv in self.servers:
            if srv is not None:
                srv.stop()

    def __enter__(self) -> "ReplicaGroup":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# --------------------------------------------------------------------------
# sharded client


class ShardedStoreClient(Store):
    """Store over a sharded topology: routes every op to the owning
    group's ``StoreClient`` (which handles leader failover within the
    group) instead of discovering ownership via REDIRECT bounces.

    Leases are **materialized lazily**: ``lease_grant`` returns a
    client-local virtual id; the first keyed op that uses it grants the
    real lease in that key's owner group and pins the virtual lease
    there (a Registration's grant-then-claim flow lands the lease
    exactly where its key lives). Using one lease across two groups is
    an error by construction — shard placement (``shard_key``) keeps a
    service's subtree in one group precisely so this never happens in
    the registry stack.

    Cross-shard reads: ``get_prefix``/``delete_prefix`` on a prefix
    shorter than the placement key fan out to every group and merge;
    ``watch``/``events_since`` raise instead (revisions are per-group —
    there is no global resume anchor), and ``try_watch`` turns that
    into the documented poll fallback.
    """

    def __init__(self, topology: dict[str, list[str]] | str, *,
                 timeout: float = 5.0, **client_kw):
        groups = parse_topology(topology) if isinstance(topology, str) \
            else topology
        self.router = ShardRouter(groups)
        self._clients = {g: StoreClient(",".join(eps), timeout=timeout,
                                        **client_kw)
                         for g, eps in groups.items()}
        self._vlock = threading.Lock()
        self._vleases: dict[int, dict] = {}  # guarded-by: _vlock
        self._next_v = 1                     # guarded-by: _vlock

    # -- lease virtualization ----------------------------------------------

    def lease_grant(self, ttl: float) -> int:
        with self._vlock:
            vid = self._next_v
            self._next_v += 1
            self._vleases[vid] = {"ttl": ttl, "group": None, "real": 0}
            return vid

    def _materialize(self, vid: int, group: str) -> int:
        if not vid:
            return 0
        with self._vlock:
            ent = self._vleases.get(vid)
            if ent is None:
                raise EdlStoreError(f"unknown virtual lease {vid}")
            if ent["group"] is None:
                ent["real"] = self._clients[group].lease_grant(ent["ttl"])
                ent["group"] = group
            elif ent["group"] != group:
                raise EdlStoreError(
                    f"lease {vid} pinned to shard group {ent['group']!r} "
                    f"cannot guard a key in {group!r} — one lease, one "
                    "shard (scope registrations to one service prefix)")
            return ent["real"]

    def lease_keepalive(self, lease: int) -> bool:
        with self._vlock:
            ent = self._vleases.get(lease)
        if ent is None:
            return False
        if ent["group"] is None:
            return True  # nothing granted server-side yet: cannot expire
        return self._clients[ent["group"]].lease_keepalive(ent["real"])

    def lease_revoke(self, lease: int) -> bool:
        with self._vlock:
            ent = self._vleases.pop(lease, None)
        if ent is None:
            return False
        if ent["group"] is None:
            return True
        return self._clients[ent["group"]].lease_revoke(ent["real"])

    # -- keyed ops ----------------------------------------------------------

    def _for_key(self, key: str) -> tuple[str, StoreClient]:
        group = self.router.owner(key)
        return group, self._clients[group]

    def put(self, key: str, value: str, lease: int = 0) -> int:
        group, client = self._for_key(key)
        return client.put(key, value, self._materialize(lease, group))

    def get(self, key: str) -> Record | None:
        return self._for_key(key)[1].get(key)

    def delete(self, key: str) -> bool:
        return self._for_key(key)[1].delete(key)

    def put_if_absent(self, key: str, value: str, lease: int = 0) -> bool:
        group, client = self._for_key(key)
        return client.put_if_absent(key, value,
                                    self._materialize(lease, group))

    def compare_and_swap(self, key: str, expect: str | None, value: str,
                         lease: int = 0) -> bool:
        group, client = self._for_key(key)
        return client.compare_and_swap(key, expect, value,
                                       self._materialize(lease, group))

    # -- prefix ops ---------------------------------------------------------

    def _prefix_clients(self, prefix: str) -> list[StoreClient]:
        owner = self.router.owner_of_prefix(prefix)
        if owner == ShardRouter.SPANS:
            return list(self._clients.values())
        return [self._clients[owner]]

    def get_prefix(self, prefix: str) -> tuple[list[Record], int]:
        records: list[Record] = []
        rev = 0
        for client in self._prefix_clients(prefix):
            recs, r = client.get_prefix(prefix)
            records.extend(recs)
            rev = max(rev, r)  # cross-shard: NOT a resume anchor
        records.sort(key=lambda r: r.key)
        return records, rev

    def delete_prefix(self, prefix: str) -> int:
        return sum(c.delete_prefix(prefix)
                   for c in self._prefix_clients(prefix))

    def events_since(self, revision: int, prefix: str = ""
                     ) -> tuple[list[Event], int, bool]:
        owner = self.router.owner_of_prefix(prefix)
        if owner == ShardRouter.SPANS:
            raise EdlStoreError(
                "events_since needs a shard-scoped prefix in a sharded "
                "topology (revisions are per-group)")
        return self._clients[owner].events_since(revision, prefix)

    def watch(self, prefix: str = "", start_revision: int | None = None,
              heartbeat: float = 2.0) -> Watch:
        owner = self.router.owner_of_prefix(prefix)
        if owner == ShardRouter.SPANS:
            raise EdlStoreError(
                "watch needs a shard-scoped prefix in a sharded topology "
                "(try_watch falls back to polling)")
        return self._clients[owner].watch(prefix, start_revision,
                                          heartbeat=heartbeat)

    def ping(self) -> bool:
        return all(c.ping() for c in self._clients.values())

    def close(self) -> None:
        for client in self._clients.values():
            client.close()


# --------------------------------------------------------------------------
# CLI: logic selftest (stdlib-only) + leader-kill chaos dryrun


def selftest(verbose: bool = True) -> int:
    """Logic-level invariants, no sockets: shard routing stability,
    raw-apply idempotence, passive/active lease handoff, snapshot
    resync, log merge ordering, backoff bounds. Pure stdlib —
    asserted: the coordination plane must run on a scheduler node with
    no accelerator stack installed."""
    failures: list[str] = []

    def check(cond: bool, what: str) -> None:
        if verbose:
            print(("ok   " if cond else "FAIL ") + what)
        if not cond:
            failures.append(what)

    # shard_key pins a service subtree to one placement unit
    check(shard_key("/edl/teachers/nodes/h:1") == "/edl/teachers",
          "shard_key: service subtree collapses to /{root}/{service}")
    check(shard_key("/edl/teachers") == "/edl/teachers",
          "shard_key: the prefix itself maps identically")

    groups = parse_topology("a:1,b:1;c:1,d:1;e:1,f:1")
    check(list(groups) == ["shard0", "shard1", "shard2"],
          f"parse_topology: ;-groups auto-named (got {list(groups)})")
    named = parse_topology("users=a:1;jobs=b:1")
    check(set(named) == {"users", "jobs"},
          "parse_topology: explicit group names")
    chunked = parse_topology("a:1,b:1,c:1,d:1", shards=2)
    check([len(v) for v in chunked.values()] == [2, 2],
          "parse_topology: flat list chunked by shard count")

    router = ShardRouter(groups)
    svc_keys = [f"/edl/svc{i}/nodes/h:{j}" for i in range(40)
                for j in range(3)]
    stable = all(router.owner(k) == router.owner(shard_key(k))
                 for k in svc_keys)
    check(stable, "router: every key of a service lands with its prefix")
    spread = {router.owner(f"/edl/svc{i}/x") for i in range(40)}
    check(len(spread) == len(groups),
          f"router: 40 services spread over all {len(groups)} groups "
          f"(hit {len(spread)})")
    check(router.owner_of_prefix("/edl/") == ShardRouter.SPANS,
          "router: one-segment prefix spans shards")

    # raw-apply: a follower mirrors the leader's stream verbatim
    leader, follower = InMemStore(), InMemStore()
    follower.set_passive(True)
    lease = leader.lease_grant(30.0)
    leader.put("/j/a", "1")
    leader.put("/j/b", "2", lease=lease)
    leader.delete("/j/a")
    evs, rev, compacted = leader.events_since(0)
    check(not compacted, "leader history covers a fresh follower")
    for ev in evs:
        if ev.type == "PUT":
            rec = leader.get(ev.key)
            follower.apply_put(ev.key, ev.value, ev.revision,
                               rec.lease if rec
                               and rec.revision == ev.revision else 0)
        else:
            follower.apply_delete(ev.key, ev.value, ev.revision)
    check(follower.current_revision == rev,
          "follower revision tracks the leader's")
    check(follower.get("/j/a") is None and
          follower.get("/j/b").value == "2",
          "follower data mirrors the leader's")
    # replay the same events: idempotent, no new revisions
    for ev in evs:
        if ev.type == "PUT":
            follower.apply_put(ev.key, ev.value, ev.revision, 0)
    check(follower.current_revision == rev,
          "replayed entries dedupe (raw-apply is idempotent)")
    # promotion: lease->keys rebuilt from records, expiry works again
    follower.apply_lease(lease, 0.05)
    clock = [100.0]
    follower._clock = lambda: clock[0]
    follower.set_passive(False)
    clock[0] += 10.0  # well past the re-based now+ttl deadline
    follower.sweep()
    check(follower.get("/j/b") is None,
          "promoted follower resumes lease-expiry duty")

    # snapshot install: wholesale replace + watcher resync signal
    src, dst = InMemStore(), InMemStore()
    for i in range(5):
        src.put(f"/s/{i}", str(i))
    watch = dst.watch("")
    dst.install_snapshot(src.snapshot_state())
    batch = watch.get(timeout=1.0)
    check(batch is not None and batch.compacted,
          "snapshot install pushes an explicit compacted batch")
    check(dst.get("/s/3").value == "3"
          and dst.current_revision == src.current_revision,
          "snapshot carries records + revision")
    evs2, _, compacted2 = dst.events_since(0)
    check(compacted2 and not evs2,
          "pre-snapshot history reads as compacted on the follower")
    watch.cancel()

    # backoff: jittered within [base, max], grows, resets
    b = Backoff(base=0.1, max_delay=0.4, rng=random.Random(7))
    delays = [b.delay() for _ in range(6)]
    check(all(0.1 <= d <= 0.4 for d in delays),
          f"backoff delays bounded (got {[round(d, 3) for d in delays]})")
    b.reset()
    check(b.delay() <= 0.2, "backoff reset returns to the base window")

    heavy = [m for m in ("torch", "jax", "numpy") if m in sys.modules]
    check(not heavy, "coordination plane imports stay torch/jax/numpy-free "
          f"(saw {heavy})")

    if failures:
        print(f"replication selftest: {len(failures)} failure(s)")
        return 1
    print("replication selftest: all checks passed")
    return 0


def dryrun(verbose: bool = True) -> int:
    """Leader-kill chaos, end to end over real sockets: a 3-replica
    group takes a registry-shaped write stream (the traffic a training
    resize generates) while a watcher consumes the event stream; the
    leader is crashed mid-stream (no resign — followers pay the full
    lease-expiry price); exits 1 unless every majority-acked write
    survives, the watch resumes by revision with ZERO lost and ZERO
    duplicated events, and a fresh leader emerges in bounded time."""
    acked: dict[str, int] = {}
    failures: list[str] = []

    def check(cond: bool, what: str) -> None:
        if verbose:
            print(("ok   " if cond else "FAIL ") + what)
        if not cond:
            failures.append(what)

    with ReplicaGroup(3, election_ttl=0.6) as group:
        first = group.wait_leader(timeout=20.0)
        check(first is not None, "initial election converges")
        client = group.client(timeout=3.0)
        watcher = group.client(timeout=3.0)
        watch = watcher.watch("/job/", start_revision=0)

        stop_writes = threading.Event()
        write_errors: list[str] = []

        def writer() -> None:
            # the resize-shaped stream: rank claims + util publishes
            i = 0
            while not stop_writes.is_set() and i < 400:
                key = f"/job/rank/{i % 16}"
                try:
                    rev = client.put(key, f"pod-{i}")
                    acked[f"pod-{i}"] = rev
                except EdlStoreError as exc:
                    write_errors.append(str(exc))
                i += 1
                time.sleep(0.005)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        time.sleep(0.6)  # let writes flow through the first leader
        killed = group.kill_leader()
        t0 = time.monotonic()
        second = group.wait_leader(timeout=20.0)
        failover_s = time.monotonic() - t0
        check(second.endpoint != killed,
              f"a different replica took over ({second.endpoint})")
        check(failover_s < 10.0,
              f"failover bounded (took {failover_s * 1e3:.0f} ms)")
        time.sleep(1.0)  # stream continues through the new leader
        stop_writes.set()
        t.join(timeout=10.0)

        # drain the watch: every acked revision exactly once, in order
        seen: dict[int, str] = {}
        duplicates = 0
        compacted = False
        deadline = time.monotonic() + 10.0
        max_acked = max(acked.values(), default=0)
        while time.monotonic() < deadline:
            batch = watch.get(timeout=0.5)
            if batch is None:
                if seen and max(seen) >= max_acked:
                    break
                continue
            compacted = compacted or batch.compacted
            for ev in batch.events:
                if ev.revision in seen:
                    duplicates += 1
                seen[ev.revision] = ev.value
        check(duplicates == 0,
              f"zero duplicate deliveries (got {duplicates})")
        check(not compacted,
              "no compaction: followers' history covered the resume point")
        lost = [v for v, rev in acked.items() if rev not in seen]
        check(not lost,
              f"zero acked events lost across the kill ({len(acked)} acked,"
              f" {len(lost)} missing)")
        check(all(seen[rev] == v for v, rev in acked.items()
                  if rev in seen),
              "delivered values match the acked writes")
        if verbose:
            print(f"     acked={len(acked)} delivered={len(seen)} "
                  f"failover={failover_s * 1e3:.0f}ms "
                  f"writer_errors={len(write_errors)}")
        watch.cancel()
        watcher.close()
        client.close()

    if failures:
        print(f"replication dryrun: {len(failures)} failure(s)")
        return 1
    print("replication dryrun: leader killed, zero events lost")
    return 0


def serve(args) -> int:
    """Run ONE replica as a standalone process (the production shape:
    one `serve` per pod of the store StatefulSet).

        python -m edl_tpu_torch.coord.replication serve \\
            --endpoint h0:2379 --endpoints h0:2379,h1:2379,h2:2379
    """
    groups = parse_topology(args.endpoints)
    group = next((g for g, eps in groups.items() if args.endpoint in eps),
                 None)
    if group is None:
        raise SystemExit(f"--endpoint {args.endpoint} not present in "
                         f"--endpoints {args.endpoints}")
    _, port = split_endpoint(args.endpoint)
    server = ReplicaServer(
        args.endpoint, port, host=args.host,
        group_endpoints=groups[group], group=group,
        topology=groups if len(groups) > 1 else None,
        election_ttl=args.election_ttl or None)
    server.start()
    log.info("replica %s serving (group %s of %d, peers %s)",
             args.endpoint, group, len(groups),
             ",".join(server.node.peers) or "<none>")
    threading.Event().wait()  # serve forever
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="edl_tpu_torch.coord.replication",
        description="store replication subsystem: serve / chaos checks")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("selftest",
                   help="logic-level invariants (stdlib-only, no sockets)")
    sub.add_parser("dryrun",
                   help="3-replica leader-kill chaos over real sockets")
    srv = sub.add_parser("serve", help="run one replica process")
    srv.add_argument("--endpoint", required=True,
                     help="this replica's advertised host:port")
    srv.add_argument("--endpoints", required=True,
                     help="full topology (EDL_TPU_STORE_ENDPOINTS syntax)")
    srv.add_argument("--host", default="0.0.0.0", help="bind address")
    srv.add_argument("--election_ttl", type=float, default=0.0,
                     help="quorum-lease TTL override (0 = env/default)")
    args = parser.parse_args(argv)
    if args.cmd == "selftest":
        return selftest()
    if args.cmd == "serve":
        return serve(args)
    return dryrun()


if __name__ == "__main__":
    raise SystemExit(main())
