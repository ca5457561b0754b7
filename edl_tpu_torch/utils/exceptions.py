"""Framework exception hierarchy (trimmed copy of
``edl_tpu.utils.exceptions``: the classes the port raises)."""


class EdlError(Exception):
    """Base class for all edl_tpu errors."""


class EdlStoreError(EdlError):
    """Coordination-store operation failed."""


class EdlRegisterError(EdlError):
    """Could not register (pod rank / service node) in the registry."""


class EdlRankError(EdlError):
    """Rank claim raced out or rank set is inconsistent."""


class EdlBarrierError(EdlError):
    """Barrier timed out or membership changed while waiting."""


class EdlLeaseExpired(EdlStoreError):
    """A lease expired while the owner believed it was alive."""


class EdlDataError(EdlError):
    """Data pipeline / task dispenser error."""


class EdlCheckpointCorrupt(EdlError):
    """A checkpoint chunk failed its integrity check (crc32 recorded at
    seal time, verified on restore). Typed so restore paths can fall back
    to the previous sealed version instead of loading garbage."""
