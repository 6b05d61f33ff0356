"""TCP JSON-lines front-end for the serving engine (port of tpu3dm/serve/server.py).

Protocol: one JSON object per line in each direction.

Requests:
  {"op": "ping"}
  {"op": "stats"}
  {"op": "register", "id": "r1",
   "source": {"path": "a.ply"} | {"points": [[x,y,z],...]} |
             {"points_b64": "<base64 float32 LE [n,3]>", "n": 123},
   "target": {...}}

Responses (always one line, always with "ok"):
  {"ok": true, "id": "r1", "transformation": [[...4x4...]],
   "fitness": 0.91, "inlier_rmse": 0.02, "bucket": 768, "latency_ms": 12.3, ...}
  {"ok": false, "id": "r1", "error": "...", "code": "too_large" | "overloaded"}

One thread per connection (``socketserver.ThreadingTCPServer``); every
connection feeds ONE shared ``ServeEngine``, so concurrent clients coalesce
into shared micro-batches.  Repeated ``path`` clouds hit a stat-validated
LRU of preprocessed clouds, and a path-cached target is one object, so its
requests take the engine's resident-target route.  Clouds are read with
``io.ply.read_ply`` and preprocessed (``preprocess_points_batch``, the
down-cloud route) on the engine's device, on the handler thread.
"""

from __future__ import annotations

import base64
import json
import socketserver
import threading
from collections import OrderedDict
from pathlib import Path

import numpy as np

from tpu3dm_torch.core.config import PipelineConfig
from tpu3dm_torch.preprocess.pipeline import ProcessedCloud
from tpu3dm_torch.serve.engine import EngineOverloaded, ServeConfig, ServeEngine
from tpu3dm_torch.utils.logging import setup_logging

logger = setup_logging(__name__)


class _CloudCache:
    """Thread-safe LRU of path -> ProcessedCloud, validated by file stat.

    Each entry records the file's (mtime_ns, size) when it was preprocessed;
    a hit whose file has changed (or vanished) is dropped, so an overwritten
    PLY never serves stale registrations, and the stale object ages out of
    the engine's id-keyed resident-target LRU.
    """

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._d: OrderedDict[str, tuple[tuple[int, int], ProcessedCloud]] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _stat(key: str) -> tuple[int, int] | None:
        try:
            st = Path(key).stat()
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size)

    def get(self, key: str) -> ProcessedCloud | None:
        sig = self._stat(key)
        with self._lock:
            ent = self._d.get(key)
            if ent is not None and sig is not None and ent[0] == sig:
                self._d.move_to_end(key)
                self.hits += 1
                return ent[1]
            if ent is not None:
                del self._d[key]  # stale: the file changed or is unreadable
            self.misses += 1
            return None

    def put(self, key: str, value: ProcessedCloud) -> None:
        if self.capacity <= 0:
            return
        sig = self._stat(key)
        if sig is None:
            return
        with self._lock:
            self._d[key] = (sig, value)
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)


def _decode_points(spec: dict, max_points: int) -> np.ndarray:
    if "points" in spec:
        pts = np.asarray(spec["points"], np.float32)
    elif "points_b64" in spec:
        raw = base64.b64decode(spec["points_b64"])
        pts = np.frombuffer(raw, dtype="<f4").reshape(-1, 3).copy()
        if "n" in spec and int(spec["n"]) != pts.shape[0]:
            raise ValueError(f"points_b64 declares n={spec['n']} but decodes to {pts.shape[0]}")
    else:
        raise ValueError("cloud spec needs 'path', 'points', or 'points_b64'")
    if pts.ndim != 2 or pts.shape[1] != 3 or pts.shape[0] == 0:
        raise ValueError(f"points must be a non-empty [n, 3] array, got {pts.shape}")
    if pts.shape[0] > max_points:
        raise ValueError(f"cloud has {pts.shape[0]} points (max {max_points})")
    if not np.isfinite(pts).all():
        raise ValueError("points contain NaN/Inf")
    return pts


class RegistrationServer:
    """An engine and a TCP listener: ``serve_forever``, or a context manager
    that serves on a background thread (tests bind port 0 and read back the
    real port)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8421,
        *,
        pipeline: PipelineConfig | None = None,
        serve: ServeConfig = ServeConfig(),
        cache_size: int = 64,
        mesh=None,
        max_line_bytes: int = 64 << 20,
        max_points: int = 2_000_000,
        path_root: str | Path | None = None,
        device=None,
    ) -> None:
        """``max_line_bytes`` bounds one request line (payload, newline
        excluded), ``max_points`` a decoded or loaded cloud, and
        ``path_root``, when set, confines ``{"path": ...}`` specs to files
        under that directory (resolved, so ``..`` cannot escape).  A
        non-loopback bind without a path_root logs a warning.  ``device``
        and ``mesh`` go to the engine (None: CUDA, raising without it)."""
        self.engine = ServeEngine(pipeline, serve, mesh=mesh, device=device)
        self.cache = _CloudCache(cache_size)
        self.max_line_bytes = int(max_line_bytes)
        self.max_points = int(max_points)
        self.path_root = Path(path_root).resolve() if path_root is not None else None
        self._started = False
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:  # noqa: D102 - protocol loop
                limit = outer.max_line_bytes
                while True:
                    # limit + 2: a payload of exactly ``limit`` bytes and its
                    # newline reads whole, and a cap-length read with no
                    # newline tells an oversized line from one at the limit.
                    line = self.rfile.readline(limit + 2)
                    if not line:
                        return
                    payload_len = len(line) - 1 if line.endswith(b"\n") else len(line)
                    if payload_len > limit:
                        # Answer once, then drop the connection: the rest of
                        # the line must not be parsed as a new request.
                        resp = {"ok": False, "error": f"request line exceeds {limit} bytes",
                                "code": "too_large"}
                        self.wfile.write(json.dumps(resp).encode() + b"\n")
                        self.wfile.flush()
                        return
                    line = line.strip()
                    if not line:
                        continue
                    resp = outer._handle_line(line)
                    self.wfile.write(json.dumps(resp).encode() + b"\n")
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        try:
            self._tcp = Server((host, port), Handler)
        except BaseException:
            self.engine.close()
            raise
        self.host, self.port = self._tcp.server_address[:2]
        if self.host not in ("127.0.0.1", "::1", "localhost") and self.path_root is None:
            logger.warning(
                "binding non-loopback host %s without path_root: remote clients can make the "
                "server read any server-readable file via 'path' specs; pass path_root to "
                "restrict them", self.host)

    def prewarm(self, caps: list[int] | None = None,
                batch_sizes: list[int] | None = None) -> float:
        """Build the kernels and run the bucket shapes before accepting
        traffic (``ServeEngine.prewarm``); returns wall seconds."""
        return self.engine.prewarm(caps, batch_sizes)

    # -- request handling ---------------------------------------------------

    def _resolve_cloud(self, spec: dict) -> ProcessedCloud:
        if not isinstance(spec, dict):
            raise ValueError("cloud spec must be an object")
        if "path" in spec:
            resolved = Path(spec["path"]).resolve()
            if self.path_root is not None and not resolved.is_relative_to(self.path_root):
                raise PermissionError(f"path outside the served root: {spec['path']}")
            key = str(resolved)
            hit = self.cache.get(key)
            if hit is not None:
                return hit
            from tpu3dm_torch.io.ply import read_ply

            pts = np.asarray(read_ply(key)["points"], np.float32)
            if pts.shape[0] > self.max_points:
                raise ValueError(f"cloud has {pts.shape[0]} points (max {self.max_points})")
        else:
            key = None
            pts = _decode_points(spec, self.max_points)
        from tpu3dm_torch.preprocess.pipeline import preprocess_points_batch

        proc = preprocess_points_batch([pts], self.engine.pipeline.preprocess,
                                       full_normals=False, device=self.engine.device)[0]
        if key is not None:
            self.cache.put(key, proc)
        return proc

    def _handle_line(self, line: bytes) -> dict:
        rid = None
        try:
            req = json.loads(line)
            rid = req.get("id")
            op = req.get("op", "register")
            if op == "ping":
                return {"ok": True, "id": rid, "op": "ping"}
            if op == "stats":
                st = self.engine.stats()
                st["cloud_cache"] = {"hits": self.cache.hits, "misses": self.cache.misses}
                return {"ok": True, "id": rid, "stats": st}
            if op != "register":
                raise ValueError(f"unknown op: {op!r}")
            src = self._resolve_cloud(req["source"])
            tgt = self._resolve_cloud(req["target"])
            r = self.engine.register(src, tgt)
            return {
                "ok": True,
                "id": rid,
                "transformation": np.asarray(r.transformation).tolist(),
                "fitness": r.fitness,
                "inlier_rmse": r.inlier_rmse,
                "bucket": r.bucket,
                "latency_ms": r.latency_ms,
                "queue_ms": r.queue_ms,
                "pack_ms": r.pack_ms,
                "device_ms": r.device_ms,
            }
        except EngineOverloaded as e:
            # A distinct code, so clients back off and retry without
            # matching strings.
            return {"ok": False, "id": rid, "code": "overloaded",
                    "error": f"{type(e).__name__}: {e}"}
        except Exception as e:  # noqa: BLE001 - reported to the client
            logger.warning("request failed: %s", e)
            return {"ok": False, "id": rid, "error": f"{type(e).__name__}: {e}"}

    # -- lifecycle ----------------------------------------------------------

    def serve_forever(self) -> None:
        logger.info("registration server listening on %s:%d", self.host, self.port)
        self._started = True
        self._tcp.serve_forever()

    def start_background(self) -> threading.Thread:
        self._started = True
        t = threading.Thread(target=self._tcp.serve_forever, name="tpu3dm-torch-serve-tcp",
                             daemon=True)
        t.start()
        return t

    def close(self) -> None:
        # shutdown() blocks forever if serve_forever never ran: call it only
        # after a start.
        if self._started:
            self._tcp.shutdown()
        self._tcp.server_close()
        self.engine.close()

    def __enter__(self) -> RegistrationServer:
        self.start_background()
        return self

    def __exit__(self, *exc) -> None:
        self.close()
