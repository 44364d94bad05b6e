"""The daemon's wire protocol, frozen here so the load does not move with
the program (``nat_tpu_torch/client.py`` is not used): a connection sends
one file's bytes, half-closes its write side, and reads NDJSON lines
(``header``, ``frame``…, ``end``) until the daemon closes."""

from __future__ import annotations

import socket
from typing import List


def request(host: str, port: int, payload: bytes,
            timeout: float = 120.0) -> List[str]:
    """One blocking request: the response's lines."""
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall(payload)
        sock.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            data = sock.recv(1 << 16)
            if not data:
                break
            chunks.append(data)
    return b"".join(chunks).decode("utf-8").splitlines()


def complete(lines: List[str]) -> bool:
    """A whole stream: a header first and an ``end`` event last."""
    return (len(lines) >= 2 and '"event":"header"' in lines[0]
            and '"event":"end"' in lines[-1])
