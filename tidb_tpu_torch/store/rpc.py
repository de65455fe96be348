# ported from tidb_tpu/store/rpc.py @ ba365f2
"""Framed message transport for the store RPC seam.

Reference analog: the gRPC/tikvpb surface of a store
(pkg/store/mockstore/unistore/tikv/server.go:45 —
KvGet/KvScan/Coprocessor service methods over protobuf).  This build's
wire format is a length-prefixed pickle frame over a local TCP socket:
the payloads are numpy column arrays and CopNode DAG trees, for which
pickle-protocol-5 is the natural zero-schema codec between trusted
processes of one cluster (the codec is isolated here so a protobuf
surface can replace it without touching callers).
"""

from __future__ import annotations

import pickle
import socket
import struct

_HDR = struct.Struct("<Q")
MAX_FRAME = 1 << 34


def send_msg(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=5)
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf += chunk
    return bytes(buf)


def recv_msg(sock: socket.socket):
    n = _HDR.unpack(_recv_exact(sock, _HDR.size))[0]
    if n > MAX_FRAME:
        raise ConnectionError(f"frame too large: {n}")
    return pickle.loads(_recv_exact(sock, n))


__all__ = ["send_msg", "recv_msg"]
