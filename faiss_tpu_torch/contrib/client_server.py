"""Search over sockets (counterpart of faiss_tpu/contrib/client_server.py;
the reference's contrib/rpc.py and contrib/client_server.py).

A SearchServer serves one index over TCP with faiss_tpu's length-prefixed
JSON + binary protocol (no pickle), so a client of either package queries a
server of either. Its searches run on the index's device, one at a time
whatever the number of connections. A search that fails on the server is
answered with ``{"ok": false, "error": ...}`` and the client raises it; a
server never drops a failed request in silence. ClientIndex fans a query
out to many servers and merges the results, the IndexShards pattern over
machines.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading

import numpy as np

from ..extra import merge_knn_results


def _send_msg(sock, header: dict, arrays: list[np.ndarray]) -> None:
    header = dict(header)
    header["arrays"] = [
        {"dtype": str(a.dtype), "shape": list(a.shape)} for a in arrays
    ]
    hbytes = json.dumps(header).encode()
    sock.sendall(struct.pack("<I", len(hbytes)))
    sock.sendall(hbytes)
    for a in arrays:
        b = np.ascontiguousarray(a).tobytes()
        sock.sendall(struct.pack("<Q", len(b)))
        sock.sendall(b)


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_msg(sock):
    (hlen,) = struct.unpack("<I", _recv_exact(sock, 4))
    header = json.loads(_recv_exact(sock, hlen))
    arrays = []
    for spec in header.pop("arrays", []):
        (blen,) = struct.unpack("<Q", _recv_exact(sock, 8))
        a = np.frombuffer(_recv_exact(sock, blen), dtype=spec["dtype"])
        arrays.append(a.reshape(spec["shape"]))
    return header, arrays


class SearchServer:
    """Serve index.search over TCP (reference: rpc.py Server)."""

    def __init__(self, index, port: int = 0, host: str = "127.0.0.1"):
        self.index = index
        self.lock = threading.Lock()  # one search at a time on the device
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        header, arrays = _recv_msg(self.request)
                    except (ConnectionError, struct.error):
                        return
                    if header["op"] == "search":
                        try:
                            with outer.lock:
                                D, I = outer.index.search(arrays[0], header["k"])
                        except Exception as e:  # answered, then the client raises
                            _send_msg(self.request, {"ok": False, "error":
                                                     f"{type(e).__name__}: {e}"}, [])
                            continue
                        _send_msg(self.request, {"ok": True}, [D, I.astype(np.int64)])
                    elif header["op"] == "ntotal":
                        _send_msg(
                            self.request,
                            {"ok": True, "ntotal": outer.index.ntotal},
                            [],
                        )
                    elif header["op"] == "close":
                        return

        self.server = socketserver.ThreadingTCPServer((host, port), Handler)
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def start(self):
        self.thread.start()
        return self

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


class ClientIndex:
    """Fan out searches to index servers and merge
    (reference: contrib/client_server.py:17 ClientIndex)."""

    def __init__(self, machine_ports):
        self.socks = []
        for host, port in machine_ports:
            s = socket.create_connection((host, port))
            self.socks.append(s)
        self.ntotal = 0
        for s in self.socks:
            _send_msg(s, {"op": "ntotal"}, [])
            header, _ = _recv_msg(s)
            self.ntotal += header["ntotal"]

    def search(self, x, k: int):
        x = np.ascontiguousarray(x, np.float32)
        Ds, Is = [], []
        for s in self.socks:  # could be parallelized with threads
            _send_msg(s, {"op": "search", "k": k}, [x])
        errors = []
        for s in self.socks:
            header, arrays = _recv_msg(s)
            if not header.get("ok"):
                errors.append(header.get("error", "the server failed"))
                continue
            Ds.append(arrays[0])
            Is.append(arrays[1])
        if errors:
            raise RuntimeError("search failed on the server: " + "; ".join(errors))
        return merge_knn_results(np.stack(Ds), np.stack(Is))

    def close(self):
        for s in self.socks:
            try:
                _send_msg(s, {"op": "close"}, [])
                s.close()
            except OSError:
                pass
