"""Network helpers: internal-IP detection and free-port acquisition.

Capability parity with ref bioengine/utils/network.py (SIOCGIFADDR
interface scan preferring RFC-1918 addresses; free-port scan that can
hold the socket until handoff to avoid TOCTOU races).
"""

from __future__ import annotations

import socket
import struct
from typing import Optional


def get_internal_ip() -> str:
    """Best-effort internal IP: UDP-connect trick, fallback to loopback."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))
            ip = s.getsockname()[0]
        return ip
    except OSError:
        pass
    try:
        import fcntl  # POSIX only
        import ipaddress

        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for ifname in _interface_names():
                try:
                    packed = struct.pack("256s", ifname[:15].encode())
                    addr = fcntl.ioctl(s.fileno(), 0x8915, packed)[20:24]
                    ip = socket.inet_ntoa(addr)
                    parsed = ipaddress.ip_address(ip)
                    if parsed.is_private and not parsed.is_loopback:
                        return ip
                except OSError:
                    continue
    except ImportError:
        pass
    return "127.0.0.1"


def _interface_names() -> list[str]:
    try:
        with open("/proc/net/dev") as f:
            return [
                line.split(":")[0].strip()
                for line in f.readlines()[2:]
                if ":" in line
            ]
    except OSError:
        return ["eth0", "en0", "lo"]


def acquire_free_port(
    start: int = 0,
    end: Optional[int] = None,
    hold: bool = False,
) -> tuple[int, Optional[socket.socket]]:
    """Find a free TCP port.

    With ``start=0`` the OS picks one. With a range, scan sequentially —
    mirrors ref bioengine/cluster/ray_cluster.py:480-532 which holds the
    bound socket until the consumer process starts (``hold=True``).
    Returns (port, held_socket_or_None); caller closes the held socket.
    """
    candidates = [0] if start == 0 else range(start, (end or start + 100) + 1)
    for port in candidates:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("0.0.0.0", port))
        except OSError:
            s.close()
            continue
        actual = s.getsockname()[1]
        if hold:
            return actual, s
        s.close()
        return actual, None
    raise RuntimeError(f"No free port found in range {start}-{end}")
