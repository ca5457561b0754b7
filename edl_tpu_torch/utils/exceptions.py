"""Framework exception hierarchy (trimmed copy of
``edl_tpu.utils.exceptions``: the classes the port raises)."""


class EdlError(Exception):
    """Base class for all edl_tpu errors."""


class EdlDataError(EdlError):
    """Data pipeline / task dispenser error."""
