"""Endpoint parsing (the part of ``edl_tpu.utils.net`` the port uses)."""

from __future__ import annotations


def split_endpoint(endpoint: str) -> tuple[str, int]:
    host, port = endpoint.rsplit(":", 1)
    return host, int(port)
