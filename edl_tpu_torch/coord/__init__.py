"""The coordination store: engine, wire, client and server, and the
redis discovery flavor (``RedisStore`` over ``MiniRedis`` or a real
redis)."""
from edl_tpu_torch.coord.redis_store import RedisStore, connect_store
from edl_tpu_torch.coord.resp import MiniRedis

__all__ = ["RedisStore", "MiniRedis", "connect_store"]
