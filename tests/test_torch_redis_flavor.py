"""The port's redis discovery flavor (coord/resp.py, coord/redis_store.py)
against the JAX package's.

Every case of the JAX package's redis tests runs against the port's
``RespClient``, ``MiniRedis`` and ``RedisStore``. Across the packages the
store layout is one: a port ``RedisStore`` over the JAX package's
``MiniRedis`` and the JAX ``RedisStore`` over the port's read each other's
records with the same values and revisions, and a lease granted by one
expires for both. The port's distill stack (TeacherServer, registrar,
discovery server, DistillReader) runs over ``redis://`` unchanged.
"""

import socket
import time

import numpy as np
import pytest

from edl_tpu_torch.coord.redis_store import (EdlRedisError, RedisStore,
                                             connect_store)
from edl_tpu_torch.coord.registry import ServiceRegistry
from edl_tpu_torch.coord.resp import (MiniRedis, RespClient, RespError,
                                      encode_command, encode_reply,
                                      read_reply, redis_glob_match)
from edl_tpu_torch.utils.exceptions import EdlLeaseExpired, EdlStoreError


@pytest.fixture()
def server():
    srv = MiniRedis().start()
    yield srv
    srv.stop()


@pytest.fixture()
def store(server):
    st = RedisStore(server.endpoint)
    yield st
    st.close()


class TestRespWire:
    def test_roundtrip_commands(self, server):
        c = RespClient(server.endpoint)
        assert c.command("PING") == "PONG"
        assert c.command("SET", "a", "1") == "OK"
        assert c.command("GET", "a") == "1"
        assert c.command("GET", "missing") is None
        assert c.command("INCR", "n") == 1
        assert c.command("INCR", "n") == 2
        assert c.command("DEL", "a", "n") == 2
        c.close()

    def test_set_nx(self, server):
        c = RespClient(server.endpoint)
        assert c.command("SET", "k", "v", "NX") == "OK"
        assert c.command("SET", "k", "w", "NX") is None
        assert c.command("GET", "k") == "v"
        c.close()

    def test_keys_glob_and_expiry(self, server):
        c = RespClient(server.endpoint)
        c.command("SET", "/svc/a", "1")
        c.command("SET", "/svc/b", "2")
        c.command("SET", "/other", "3")
        assert c.command("KEYS", "/svc/*") == ["/svc/a", "/svc/b"]
        assert c.command("PEXPIRE", "/svc/a", 30) == 1
        time.sleep(0.08)
        assert c.command("GET", "/svc/a") is None
        assert c.command("KEYS", "/svc/*") == ["/svc/b"]
        c.close()

    def test_set_replaces_set_key_and_nx_is_type_agnostic(self, server):
        c = RespClient(server.endpoint)
        c.command("SADD", "k1", "m")
        assert c.command("SET", "k1", "v", "NX") is None
        c.command("SADD", "k2", "m")
        assert c.command("SET", "k2", "v") == "OK"
        assert c.command("GET", "k2") == "v"
        assert c.command("KEYS", "k2") == ["k2"]
        c.close()

    def test_unknown_command_is_error(self, server):
        c = RespClient(server.endpoint)
        with pytest.raises(RespError):
            c.command("WHATEVER")
        assert c.command("PING") == "PONG"
        c.close()

    def test_garbage_bytes_drop_connection_not_server(self, server):
        s = socket.create_connection(("127.0.0.1", server.port), timeout=2)
        s.sendall(b"not resp at all\r\n")
        s.close()
        c = RespClient(server.endpoint)
        assert c.command("PING") == "PONG"
        c.close()

    def test_resp_error_is_a_store_error(self):
        assert issubclass(RespError, EdlStoreError)
        assert issubclass(EdlRedisError, EdlStoreError)


# The wire codec and the glob matcher are pure functions: the JAX
# package's give the same bytes and answers on the same inputs.
_COMMANDS = [("PING",), ("SET", "k", "v", "PX", 250), ("SCAN", 0, "MATCH",
             "/svc\\[1\\]/*", "COUNT", 100), ("GET", b"\x00bin"),
             ("MGET", "a", "b", "c")]
_REPLIES = ["OK", "PONG", None, 7, -1, "x" * 300, ["a", None, 3],
            [], ["message", "!edl:events", '{"k": 1}'],
            RespError("ERR bad")]
_GLOBS = [("/svc/*", "/svc/a"), ("/svc/*", "/other"), ("a?c", "abc"),
          ("a[bc]d", "acd"), ("a[^b]d", "abd"), ("a[a-c]", "ab"),
          ("/svc\\[1\\]/*", "/svc[1]/nodes/a"), ("/svc\\[1\\]/*", "/svc1/x"),
          ("\\*", "*"), ("\\*", "x"), ("a\\?", "a?"), ("a\\?", "ab"),
          ("x[\\]]y", "x]y"), ("*", ""), ("h*llo", "heeeello"),
          ("[", "["), ("a[", "a[")]


def test_codec_and_glob_match_jax():
    from edl_tpu.coord import resp as jresp

    for cmd in _COMMANDS:
        assert encode_command(cmd) == jresp.encode_command(cmd)
    for reply in _REPLIES:
        jreply = (jresp.RespError(str(reply)) if isinstance(reply, RespError)
                  else reply)
        assert encode_reply(reply) == jresp.encode_reply(jreply), reply
    def outcome(fn, pattern, key):
        try:
            return fn(pattern, key)
        except Exception as exc:  # noqa: BLE001 — the same fault both sides
            return type(exc).__name__

    for pattern, key in _GLOBS:
        assert outcome(redis_glob_match, pattern, key) \
            == outcome(jresp.redis_glob_match, pattern, key), (pattern, key)


def test_read_reply_parses_what_encode_reply_writes():
    import io

    for reply in _REPLIES:
        if isinstance(reply, RespError):
            continue
        got = read_reply(io.BytesIO(encode_reply(reply)))
        assert got == reply


class TestRedisStore:
    def test_put_get_revisions_monotonic(self, store):
        r1 = store.put("/k1", "a")
        r2 = store.put("/k2", "b")
        assert r2 > r1
        rec = store.get("/k1")
        assert rec.value == "a" and rec.revision == r1
        assert store.get("/nope") is None

    def test_get_prefix_sorted_and_rev(self, store):
        store.put("/p/b", "2")
        store.put("/p/a", "1")
        store.put("/q/x", "3")
        recs, rev = store.get_prefix("/p/")
        assert [r.key for r in recs] == ["/p/a", "/p/b"]
        assert rev >= max(r.revision for r in recs)

    def test_put_if_absent(self, store):
        assert store.put_if_absent("/once", "first")
        assert not store.put_if_absent("/once", "second")
        assert store.get("/once").value == "first"

    def test_delete_and_prefix(self, store):
        store.put("/d/a", "1")
        store.put("/d/b", "2")
        assert store.delete("/d/a")
        assert not store.delete("/d/a")
        assert store.delete_prefix("/d/") == 1

    def test_lease_expiry_removes_keys(self, store):
        lease = store.lease_grant(0.08)
        store.put("/leased", "v", lease=lease)
        assert store.get("/leased") is not None
        time.sleep(0.15)
        assert store.get("/leased") is None
        assert not store.lease_keepalive(lease)

    def test_lease_keepalive_extends(self, store):
        lease = store.lease_grant(0.15)
        store.put("/ka", "v", lease=lease)
        for _ in range(4):
            time.sleep(0.07)
            assert store.lease_keepalive(lease)
        assert store.get("/ka") is not None

    def test_key_written_late_in_lease_expires_with_lease(self, store):
        lease = store.lease_grant(3.0)
        time.sleep(1.8)
        store.put("/late", "v", lease=lease)
        assert store.get("/late") is not None
        time.sleep(1.5)
        assert not store.lease_keepalive(lease)
        assert store.get("/late") is None

    def test_lease_revoke_deletes(self, store):
        lease = store.lease_grant(5.0)
        store.put("/r1", "a", lease=lease)
        store.put("/r2", "b", lease=lease)
        assert store.lease_revoke(lease)
        assert store.get("/r1") is None and store.get("/r2") is None

    def test_put_with_dead_lease_raises_and_writes_nothing(self, store):
        lease = store.lease_grant(0.05)
        time.sleep(0.12)
        with pytest.raises(EdlLeaseExpired):
            store.put("/x", "v", lease=lease)
        assert store.get("/x") is None

    def test_prefix_with_glob_chars_in_service_name(self, store):
        store.put("/svc[1]/nodes/a", "1")
        store.put("/svc[1]/nodes/b", "2")
        store.put("/svc1/nodes/c", "3")
        recs, _ = store.get_prefix("/svc[1]/nodes/")
        assert [r.key for r in recs] == ["/svc[1]/nodes/a",
                                        "/svc[1]/nodes/b"]

    def test_client_recovers_after_transport_error(self, server, store):
        store._client._sock.close()
        assert store.ping()
        store.put("/after", "ok")
        assert store.get("/after").value == "ok"

    def test_cas_single_writer_semantics(self, store):
        assert store.compare_and_swap("/c", None, "v1")
        assert not store.compare_and_swap("/c", "wrong", "v2")
        assert store.compare_and_swap("/c", "v1", "v2")
        assert store.get("/c").value == "v2"

    def test_cas_rebinds_lease(self, store):
        l1 = store.lease_grant(0.1)
        store.put("/own", "tok", lease=l1)
        time.sleep(0.05)
        l2 = store.lease_grant(0.5)
        assert store.compare_and_swap("/own", "tok", "tok2", lease=l2)
        time.sleep(0.2)
        assert store.lease_keepalive(l2)
        assert store.get("/own").value == "tok2"

    def test_overwrite_detaches_old_lease(self, store):
        lease = store.lease_grant(0.2)
        store.put("/det", "a", lease=lease)
        store.put("/det", "b")
        store.lease_revoke(lease)
        assert store.get("/det").value == "b"
        time.sleep(0.3)
        assert store.get("/det") is not None

    def test_events_since_out_of_scope(self, store):
        with pytest.raises(EdlRedisError):
            store.events_since(0)

    def test_connect_store_scheme(self, server):
        st = connect_store(f"redis://{server.endpoint}")
        assert isinstance(st, RedisStore)
        assert st.ping()
        st.close()

    def test_watch_sees_puts_and_deletes_but_not_expiry(self, store):
        """Mutations through the class arrive over pub/sub, filtered by
        prefix; a TTL expiry emits nothing; a reconnect of the feed
        comes back as a ``compacted`` batch (pub/sub has no replay)."""
        watch = store.watch("/w/")
        assert watch.expiry_events is False
        try:
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:   # until subscribed
                store.put("/w/probe", "p")
                batch = watch.get(timeout=0.2)
                if batch is not None and batch.events:
                    break
            while watch.get(timeout=0.2) is not None:
                pass
            lease = store.lease_grant(0.1)
            store.put("/w/a", "1")
            store.put("/w/b", "2", lease=lease)
            store.put("/other", "x")
            store.delete("/w/a")
            seen = []
            deadline = time.monotonic() + 3.0
            while len(seen) < 3 and time.monotonic() < deadline:
                batch = watch.get(timeout=0.5)
                if batch is not None:
                    seen.extend((e.type, e.key) for e in batch.events)
            assert seen == [("PUT", "/w/a"), ("PUT", "/w/b"),
                            ("DELETE", "/w/a")]
            time.sleep(0.3)   # /w/b's lease lapses silently
            assert store.get("/w/b") is None
            assert watch.get(timeout=0.3) is None
            watch._sock.shutdown(socket.SHUT_RDWR)   # the feed drops
            batch = watch.get(timeout=5.0)
            assert batch is not None and batch.compacted
        finally:
            watch.cancel()

    def test_start_revision_comes_back_compacted(self, store):
        rev = store.put("/s/a", "1")
        watch = store.watch("/s/", start_revision=rev)
        try:
            batch = watch.get(timeout=2.0)
            assert batch is not None and batch.compacted
        finally:
            watch.cancel()


class TestRegistryOverRedis:
    def test_register_heartbeat_expiry(self, store):
        reg = ServiceRegistry(store, root="edl_distill")
        registration = reg.register("svc", "10.0.0.1:9000",
                                    info="{}", ttl=0.4)
        try:
            metas = reg.get_service("svc")
            assert [m.server for m in metas] == ["10.0.0.1:9000"]
            time.sleep(0.9)
            assert [m.server for m in reg.get_service("svc")] \
                == ["10.0.0.1:9000"]
        finally:
            registration.stop()
        deadline = time.time() + 3
        while time.time() < deadline and reg.get_service("svc"):
            time.sleep(0.05)
        assert reg.get_service("svc") == []

    def test_update_info_visible(self, store):
        reg = ServiceRegistry(store, root="edl_distill")
        registration = reg.register("svc", "t:1", info="old", ttl=2.0)
        try:
            registration.update_info("new")
            deadline = time.time() + 2
            while time.time() < deadline:
                metas = reg.get_service("svc")
                if metas and metas[0].info == "new":
                    break
                time.sleep(0.05)
            assert reg.get_service("svc")[0].info == "new"
        finally:
            registration.stop()


# -- across the packages -----------------------------------------------------


def _mixed_pair(which):
    """(server, writer store, reader store) with the server from one
    package and the two stores from different packages."""
    from edl_tpu.coord.redis_store import RedisStore as JRedisStore
    from edl_tpu.coord.resp import MiniRedis as JMiniRedis

    if which == "port_store_on_jax_server":
        srv = JMiniRedis().start()
        return srv, RedisStore(srv.endpoint), JRedisStore(srv.endpoint)
    srv = MiniRedis().start()
    return srv, JRedisStore(srv.endpoint), RedisStore(srv.endpoint)


@pytest.mark.parametrize("which", ["port_store_on_jax_server",
                                   "jax_store_on_port_server"])
def test_records_revisions_and_leases_agree_across_packages(which):
    srv, writer, reader = _mixed_pair(which)
    try:
        r1 = writer.put("/x/a", "1")
        r2 = reader.put("/x/b", "2")
        assert r2 == r1 + 1          # one INCR !edl:rev counter
        for st in (writer, reader):
            recs, rev = st.get_prefix("/x/")
            assert [(r.key, r.value, r.revision) for r in recs] \
                == [("/x/a", "1", r1), ("/x/b", "2", r2)]
            assert rev == r2
        assert not reader.put_if_absent("/x/a", "again")
        lease = writer.lease_grant(0.3)
        writer.put("/x/leased", "v", lease=lease)
        assert reader.get("/x/leased").value == "v"
        assert reader.lease_keepalive(lease)   # the other side re-arms it
        time.sleep(0.15)
        assert writer.get("/x/leased") is not None
        time.sleep(0.45)
        assert reader.get("/x/leased") is None
        assert writer.get("/x/leased") is None
        assert not reader.lease_keepalive(lease)
        lease2 = reader.lease_grant(5.0)
        reader.put("/x/r", "v", lease=lease2)
        assert writer.lease_revoke(lease2)
        assert reader.get("/x/r") is None
    finally:
        writer.close()
        reader.close()
        srv.stop()


# -- the distill stack over redis:// ---------------------------------------


def _table_teacher(feeds):
    out = {"logits": np.asarray(feeds["x"], dtype=np.float32) * 2.0}
    return lambda: out


def test_distill_stack_over_redis(server):
    """Teachers register in the redis registry, the discovery server
    balances them, a DistillReader consumes through dynamic discovery:
    all of the port's, all over RESP."""
    from edl_tpu_torch.distill.discovery_server import DiscoveryServer
    from edl_tpu_torch.distill.reader import DistillReader
    from edl_tpu_torch.distill.registrar import TeacherRegistrar
    from edl_tpu_torch.distill.teacher_server import TeacherServer

    store = connect_store(f"redis://{server.endpoint}")
    teacher = TeacherServer(_table_teacher, host="127.0.0.1").start()
    endpoint = f"127.0.0.1:{teacher.port}"
    registrar = TeacherRegistrar(store, "svc", endpoint, ttl=1.0,
                                 probe_timeout=10.0, probe_interval=0.05)
    registrar.start()
    disco = DiscoveryServer(connect_store(f"redis://{server.endpoint}"),
                            port=0, host="127.0.0.1", tick_interval=0.1,
                            client_ttl=10.0).start()
    rng = np.random.default_rng(0)
    batches = [{"x": rng.normal(size=(8, 3)).astype(np.float32)}
               for _ in range(6)]
    dr = DistillReader(lambda: iter(batches), feeds=["x"],
                       predicts=["logits"], discovery=disco.endpoint,
                       service="svc", teacher_batch_size=4,
                       manage_interval=0.05)
    try:
        out = list(dr())
        assert len(out) == 6
        for got, fed in zip(out, batches):
            np.testing.assert_allclose(got["logits"], fed["x"] * 2.0,
                                       rtol=1e-6)
        assert teacher.batcher.stats()["served_rows"] == 48
    finally:
        dr.close()
        disco.stop()
        registrar.stop()
        teacher.stop()
        store.close()


def test_jax_registry_reads_a_port_registration():
    """A teacher registered through the port's registry over the port's
    MiniRedis is listed by the JAX package's registry over the same
    redis, and leaves it when the registration stops."""
    from edl_tpu.coord.redis_store import RedisStore as JRedisStore
    from edl_tpu.coord.registry import ServiceRegistry as JRegistry

    srv = MiniRedis().start()
    ours, theirs = RedisStore(srv.endpoint), JRedisStore(srv.endpoint)
    try:
        registration = ServiceRegistry(ours, root="edl_distill").register(
            "svc", "10.0.0.2:9000", info="{}", ttl=0.4)
        jreg = JRegistry(theirs, root="edl_distill")
        assert [m.server for m in jreg.get_service("svc")] \
            == ["10.0.0.2:9000"]
        registration.stop()
        deadline = time.time() + 3
        while time.time() < deadline and jreg.get_service("svc"):
            time.sleep(0.05)
        assert jreg.get_service("svc") == []
    finally:
        ours.close()
        theirs.close()
        srv.stop()
