"""Network helpers: free ports, host IP, endpoint parsing and a TCP
aliveness probe (copy of ``edl_tpu.utils.net``)."""

from __future__ import annotations

import socket


def free_port() -> int:
    """Ask the OS for a currently-free TCP port."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("", 0))
        return s.getsockname()[1]


def host_ip() -> str:
    """First non-loopback IPv4 of this host; falls back to 127.0.0.1."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            # No packets are sent; this just selects the outbound interface.
            s.connect(("10.255.255.255", 1))
            ip = s.getsockname()[0]
        if not ip.startswith("127."):
            return ip
    except OSError:
        pass
    try:
        for info in socket.getaddrinfo(socket.gethostname(), None,
                                       socket.AF_INET):
            ip = info[4][0]
            if not ip.startswith("127."):
                return ip
    except OSError:
        pass
    return "127.0.0.1"


def split_endpoint(endpoint: str) -> tuple[str, int]:
    host, port = endpoint.rsplit(":", 1)
    return host, int(port)



def is_endpoint_alive(endpoint: str, timeout: float = 1.0) -> bool:
    """TCP connect probe: True iff something is listening at host:port."""
    host, port = split_endpoint(endpoint)
    try:
        with socket.create_connection((host, port), timeout=timeout):
            return True
    except OSError:
        return False
