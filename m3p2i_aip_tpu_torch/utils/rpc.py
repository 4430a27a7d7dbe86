"""Minimal length-prefixed TCP RPC: the two-terminal workflow's transport.

Port of ``m3p2i_aip_tpu/utils/rpc.py`` with the same framing, so either
package's client talks to either package's server.  The reference runs the
planner and the actuated sim as two processes bridged by zerorpc over
``tcp://*:4242`` (reactive_tamp.py:92-94, sim.py:29-30); here stdlib
sockets carry frames of ``[u32 length | payload]``: a JSON header naming the
method, then N binary arguments in :mod:`.data_transfer`'s numpy format.

Only the reference's RPC surface is dispatched: ``run_tamp(dof_state,
root_state) -> action``, ``get_suction() -> int``, ``get_trajs() -> array``.
A method that raises sends the client its error, then raises in the server
too: a failed kernel build or launch stops both ends.
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Callable, List

from m3p2i_aip_tpu_torch.utils.data_transfer import array_to_bytes, bytes_to_numpy

_HDR = struct.Struct("!I")
_ALLOWED_METHODS = ("run_tamp", "get_suction", "get_trajs")


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        c = sock.recv(n)
        if not c:
            raise ConnectionError("peer closed")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return _recv_exact(sock, n)


def _send_message(sock: socket.socket, header: dict, blobs: List[bytes]) -> None:
    _send_frame(sock, json.dumps(dict(header, n_blobs=len(blobs))).encode())
    for b in blobs:
        _send_frame(sock, b)


def _recv_message(sock: socket.socket):
    header = json.loads(_recv_frame(sock).decode())
    return header, [_recv_frame(sock) for _ in range(header.get("n_blobs", 0))]


class Server:
    """Serve an object's allow-listed methods, one client and one request at
    a time (the reference's RPC is synchronous per control tick).  Binds
    localhost by default (``host="0.0.0.0"`` for a sim terminal on another
    host); ``port=0`` takes an ephemeral port, read back from ``port``."""

    def __init__(self, obj, host: str = "127.0.0.1", port: int = 4242):
        self._obj = obj
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(1)
        self.port = self._sock.getsockname()[1]

    def run(self) -> None:
        """Accept clients until :meth:`close`."""
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # the listening socket was closed: a clean shutdown
            try:
                self.serve_client(conn)
            finally:
                conn.close()

    def serve_client(self, conn: socket.socket) -> None:
        """Answer one client until it leaves.  A lost connection ends the
        client's session; an error in a method is sent to the client and
        raised here."""
        while True:
            try:
                header, blobs = _recv_message(conn)
            except (ConnectionError, OSError):
                return
            name = header.get("method")
            if name == "__shutdown__":
                reply, out = {"ok": True}, []
            elif name not in _ALLOWED_METHODS:
                reply, out = {"ok": False, "error": f"method not allowed: {name}"}, []
            else:
                method: Callable = getattr(self._obj, name)
                try:
                    result = method(*(bytes_to_numpy(b) for b in blobs))
                except BaseException as e:
                    _send_message(conn, {"ok": False, "error": f"{type(e).__name__}: {e}"}, [])
                    raise
                if result is None or isinstance(result, (bool, int, float)):
                    reply, out = {"ok": True, "scalar": result}, []
                else:
                    reply, out = {"ok": True}, [array_to_bytes(result)]
            try:
                _send_message(conn, reply, out)
            except (ConnectionError, OSError):
                return
            if name == "__shutdown__":
                return

    def close(self) -> None:
        """Stop listening; a thread blocked in :meth:`run` returns."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)  # wakes a blocked accept(), which close() alone does not
        except OSError:
            pass  # never listened, or already shut down
        self._sock.close()


class Client:
    """The zerorpc client's surface (sim.py:29-30): ``call(method, *arrays)``
    or ``client.method(*arrays)``; a server-side error raises here."""

    def __init__(self):
        self._sock: socket.socket = None

    def connect(self, host: str = "127.0.0.1", port: int = 4242, timeout: float = 30.0) -> "Client":
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.settimeout(None)
        return self

    def call(self, method: str, *arrays):
        _send_message(self._sock, {"method": method}, [array_to_bytes(a) for a in arrays])
        header, blobs = _recv_message(self._sock)
        if not header.get("ok", True):
            raise RuntimeError(header.get("error", "rpc error"))
        if "scalar" in header:
            return header["scalar"]
        return bytes_to_numpy(blobs[0]) if blobs else None

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda *arrays: self.call(name, *arrays)

    def close(self) -> None:
        if self._sock is not None:
            try:
                _send_message(self._sock, {"method": "__shutdown__"}, [])
                _recv_message(self._sock)
            except (ConnectionError, OSError):
                pass
            self._sock.close()
