"""Process-unique client identity (the part of
``edl_tpu.utils.unique_name`` the port uses: a pod's default id)."""

from __future__ import annotations

import os
import time

from edl_tpu_torch.utils.net import host_ip


def client_id(channel: int = 0) -> str:
    """Globally-unique-ish client identity: ip-pid-channel-timestamp."""
    return f"{host_ip()}-{os.getpid()}-{channel}-{time.monotonic_ns()}"
