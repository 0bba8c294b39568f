"""Minimal RESP (REdis Serialization Protocol) client over a stdlib
socket — the data plane for redis-protocol systems (disque, raftis/redis).

The reference suites use Java client libraries (jedis, spinach); this
rebuild speaks the wire protocol directly so no third-party dependency is
needed. Covers RESP2: simple strings, errors, integers, bulk strings,
arrays, with command pipelining via execute_many. The port's copy of
``jepsen_tpu.suites.resp``."""

from __future__ import annotations

import socket
from typing import Any, List, Optional, Sequence


class RespError(RuntimeError):
    """A -ERR reply."""


class RespClient:
    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.addr = (host, int(port))
        self.timeout = timeout
        self.sock: Optional[socket.socket] = None
        self._buf = b""

    # -- connection --------------------------------------------------------

    def connect(self) -> "RespClient":
        self.sock = socket.create_connection(self.addr, self.timeout)
        self.sock.settimeout(self.timeout)
        return self

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            finally:
                self.sock = None

    # -- wire format -------------------------------------------------------

    @staticmethod
    def encode_command(args: Sequence) -> bytes:
        """An array of bulk strings."""
        out = [f"*{len(args)}\r\n".encode()]
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode()
            out.append(f"${len(b)}\r\n".encode())
            out.append(b)
            out.append(b"\r\n")
        return b"".join(out)

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _read_reply(self) -> Any:
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = self._read_exact(n)
            self._read_exact(2)  # trailing \r\n
            return data
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RespError(f"unparseable reply line: {line!r}")

    # -- public API --------------------------------------------------------

    def execute(self, *args) -> Any:
        if self.sock is None:
            self.connect()
        self.sock.sendall(self.encode_command(args))
        return self._read_reply()

    def execute_many(self, commands: Sequence[Sequence]) -> List[Any]:
        """Pipelined execution: one write, n replies."""
        if self.sock is None:
            self.connect()
        self.sock.sendall(b"".join(self.encode_command(c)
                                   for c in commands))
        return [self._read_reply() for _ in commands]
