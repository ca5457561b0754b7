"""Framework exception hierarchy (trimmed copy of
``edl_tpu.utils.exceptions``: the classes the port raises)."""


class EdlError(Exception):
    """Base class for all edl_tpu errors."""


class EdlDataError(EdlError):
    """Data pipeline / task dispenser error."""


class EdlCheckpointCorrupt(EdlError):
    """A checkpoint chunk failed its integrity check (crc32 recorded at
    seal time, verified on restore). Typed so restore paths can fall back
    to the previous sealed version instead of loading garbage."""
