"""Consistent hash ring with virtual nodes and copy-on-write snapshots
(copy of ``edl_tpu.coord.consistent_hash``).

Capability parity: reference discovery/consistent_hash.py:21-141 (md5 ring,
300 virtual nodes, copy-on-write reads so a single writer needs no reader
locks, versioned snapshots). Used by the distill balancer to shard service
names across discovery replicas with REDIRECT responses
(distill/balance_table.py:363-433).

Design: an immutable ``_Ring`` snapshot (sorted hash points + bisect lookup)
swapped atomically under a writer lock; readers grab ``self._ring`` once —
Python reference assignment is atomic — and never block.
"""

from __future__ import annotations

import bisect
import hashlib
import threading


def _hash(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode("utf-8")).digest()[:8], "big")


class _Ring:
    __slots__ = ("points", "owners", "nodes", "version")

    def __init__(self, nodes: frozenset[str], vnodes: int, version: int):
        pairs = sorted(
            (_hash(f"{node}#{i}"), node)
            for node in nodes
            for i in range(vnodes)
        )
        self.points = [p for p, _ in pairs]
        self.owners = [n for _, n in pairs]
        self.nodes = nodes
        self.version = version

    def lookup(self, key: str) -> str | None:
        if not self.points:
            return None
        idx = bisect.bisect_right(self.points, _hash(key)) % len(self.points)
        return self.owners[idx]


class ConsistentHash:
    def __init__(self, nodes: list[str] | None = None, vnodes: int = 300):
        self._vnodes = vnodes
        self._write_lock = threading.Lock()
        self._ring = _Ring(frozenset(nodes or ()), vnodes, version=0)

    @property
    def version(self) -> int:
        return self._ring.version

    @property
    def nodes(self) -> frozenset[str]:
        return self._ring.nodes

    def add_node(self, node: str) -> None:
        with self._write_lock:
            ring = self._ring
            if node in ring.nodes:
                return
            self._ring = _Ring(ring.nodes | {node}, self._vnodes,
                               ring.version + 1)

    def remove_node(self, node: str) -> None:
        with self._write_lock:
            ring = self._ring
            if node not in ring.nodes:
                return
            self._ring = _Ring(ring.nodes - {node}, self._vnodes,
                               ring.version + 1)

    def set_nodes(self, nodes: list[str]) -> None:
        with self._write_lock:
            new = frozenset(nodes)
            if new != self._ring.nodes:
                self._ring = _Ring(new, self._vnodes, self._ring.version + 1)

    def lookup(self, key: str) -> str | None:
        return self._ring.lookup(key)

    def lookup_with_version(self, key: str) -> tuple[str | None, int]:
        ring = self._ring
        return ring.lookup(key), ring.version
