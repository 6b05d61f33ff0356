"""Blocking client for the registration server (the port's copy of
tpu3dm/serve/client.py; the serve/server.py protocol).

One socket, newline-delimited JSON both ways.  Safe for sequential use from
one thread; open one client per thread for concurrency (the server batches
across connections).
"""

from __future__ import annotations

import base64
import json
import socket

import numpy as np


class RegistrationClient:
    def __init__(self, host: str, port: int, *, timeout: float = 120.0) -> None:
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._rfile = self._sock.makefile("rb")
        self._seq = 0

    def _call(self, req: dict) -> dict:
        self._seq += 1
        req.setdefault("id", f"c{self._seq}")
        self._sock.sendall(json.dumps(req).encode() + b"\n")
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        resp = json.loads(line)
        if not resp.get("ok"):
            raise RuntimeError(resp.get("error", "request failed"))
        return resp

    @staticmethod
    def _cloud_spec(cloud) -> dict:
        """str / Path -> path spec; array -> compact base64 float32 spec."""
        if isinstance(cloud, (str, bytes)) or hasattr(cloud, "__fspath__"):
            return {"path": str(cloud)}
        pts = np.ascontiguousarray(np.asarray(cloud, np.float32))
        if pts.ndim != 2 or pts.shape[1] != 3:
            raise ValueError(f"expected [n, 3] points, got {pts.shape}")
        return {"points_b64": base64.b64encode(pts.astype("<f4").tobytes()).decode(),
                "n": int(pts.shape[0])}

    def ping(self) -> bool:
        return bool(self._call({"op": "ping"})["ok"])

    def stats(self) -> dict:
        return self._call({"op": "stats"})["stats"]

    def register(self, source, target) -> dict:
        """Register source onto target; each is a PLY path or an [n, 3]
        array.  Returns the response dict: ``transformation`` is a [4, 4]
        nested list (target <- source), with ``fitness``, ``inlier_rmse``,
        ``bucket``, ``latency_ms`` and its components."""
        return self._call({"op": "register", "source": self._cloud_spec(source),
                           "target": self._cloud_spec(target)})

    def close(self) -> None:
        try:
            self._rfile.close()
        finally:
            self._sock.close()

    def __enter__(self) -> RegistrationClient:
        return self

    def __exit__(self, *exc) -> None:
        self.close()
