"""Store from an endpoint string (trimmed copy of
``edl_tpu.coord.redis_store``: ``connect_store`` and its ``StoreClient``
path).

Every consumer that is handed an endpoint string (the migration service,
the utilization publisher) connects through ``connect_store``. The JAX
package also maps ``redis://host:port`` to a Redis-backed store and a
sharded endpoint (``g0=h0:p,...;g1=...`` or ``EDL_TPU_STORE_SHARDS`` > 1)
to its sharded client; neither is ported, and both raise
``EdlStoreError`` naming ROADMAP Queue 1 item 17.
"""

from __future__ import annotations

from edl_tpu_torch.coord.client import StoreClient
from edl_tpu_torch.coord.store import Store
from edl_tpu_torch.utils import config
from edl_tpu_torch.utils.exceptions import EdlStoreError


def connect_store(endpoint: str, timeout: float = 10.0) -> Store:
    """``h0:p,h1:p,...`` -> StoreClient over the replica list."""
    if endpoint.startswith("redis://"):
        raise EdlStoreError("a redis:// store endpoint is not ported yet "
                            "(ROADMAP Queue 1 item 17)")
    if ";" in endpoint or config.env_int("EDL_TPU_STORE_SHARDS", 1) > 1:
        raise EdlStoreError("a sharded store endpoint is not ported yet "
                            "(ROADMAP Queue 1 item 17)")
    return StoreClient(endpoint, timeout=timeout)
