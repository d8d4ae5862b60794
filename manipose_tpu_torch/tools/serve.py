"""HTTP pose-lifting server: batch and streaming inference over JSON.

The port's copy of ``tools/serve.py``: a stdlib ``http.server`` front end
for :class:`manipose_tpu_torch.serving.Predictor`. Endpoints:

- ``GET  /healthz``            -> {"status": "ok", model and device info}
- ``POST /predict``            body {"keypoints": [N x J x 2]}
                               -> {"poses": [N x J x 3]} (meters,
                               root-relative camera frame); optional
                               ``"hypotheses": true`` adds the per-window
                               hypotheses and scores of rMCL models;
                               optional ``"window_stride": S`` selects the
                               overlapping quality mode.
- ``POST /stream/open``        body {"stride": int, "lookahead": int?}
                               -> {"session": id, "latency_frames": n}
- ``POST /stream/<id>/push``   body {"frames": [k x J x 2]}
                               -> {"poses": [m x J x 3]} (the frames that
                               cleared the lookahead margin; may be empty)
- ``POST /stream/<id>/flush``  -> {"poses": ...}, the tail; closes the
                               session
- ``POST /stream/<id>/close``  discard without flushing; open sessions
                               are capped (``--max-sessions``, default 64)

A missing session is 404, a bad request 400, and a body over 64 MiB is
refused unread. Single-threaded: one process owns one device context and
serves requests in order. Scale out with one process per card behind an
HTTP load balancer; ``--data-parallel`` splits each batch over this host's
cards instead. It runs on the card unless the overrides say ``device=cpu``:

  python -m manipose_tpu_torch.tools.serve --port 8035 --checkpoint RUN_DIR \\
      --tag best_mpjpe [--quantize] [--data-parallel] [device=cpu] [overrides...]
"""

from __future__ import annotations

import argparse
import json
import uuid
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np


def build_predictor(args):
    from ..config import load_config
    from ..serving import Predictor

    cfg = load_config("config", overrides=list(args.overrides))
    kw = dict(
        cfg=cfg,
        batch_size=args.batch_size,
        tta=not args.no_tta,
        quantize=args.quantize,
        data_parallel=args.data_parallel,
        device=cfg.get("device", "cuda"),
    )
    return Predictor.from_any(args.checkpoint, tag=args.tag, **kw)


class PoseServer:
    """The request logic, apart from the HTTP plumbing."""

    def __init__(self, predictor, max_sessions: int = 64):
        self.predictor = predictor
        self.max_sessions = max_sessions
        self.sessions = {}

    def healthz(self):
        p = self.predictor
        return {
            "status": "ok",
            "arch": p.cfg.model.arch,
            "seq_len": p.seq_len,
            "joints": p.skeleton.num_joints,
            "tta": p.tta,
            "quantized": p.quantized,
            "data_parallel": p.data_parallel,
            "device": p.device.type,
            "open_sessions": len(self.sessions),
        }

    def predict(self, body):
        if "keypoints" not in body:
            raise ValueError("missing required field 'keypoints'")
        j = self.predictor.skeleton.num_joints
        kps = np.asarray(body["keypoints"], np.float32)
        if kps.ndim != 3 or kps.shape[1:] != (j, 2):
            raise ValueError(f"keypoints must be (N, {j}, 2); got {list(kps.shape)}")
        window_stride = body.get("window_stride")
        if window_stride is not None:
            window_stride = int(window_stride)
        if body.get("hypotheses"):
            poses, hyps, scores = self.predictor.predict_video(
                kps, return_hypotheses=True, window_stride=window_stride
            )
            out = {"poses": poses.tolist()}
            if hyps is not None:
                out["hypotheses"] = hyps.tolist()
                out["scores"] = scores.tolist()
            return out
        return {"poses": self.predictor.predict_video(
            kps, window_stride=window_stride).tolist()}

    def stream_open(self, body):
        if len(self.sessions) >= self.max_sessions:
            raise ValueError(
                f"too many open sessions ({self.max_sessions}); "
                "flush or close some first"
            )
        sess = self.predictor.stream(
            stride=int(body.get("stride", 1)),
            lookahead=int(body["lookahead"]) if "lookahead" in body else None,
        )
        sid = uuid.uuid4().hex[:12]
        self.sessions[sid] = sess
        return {
            "session": sid,
            "stride": sess.stride,
            "lookahead": sess.lookahead,
            "latency_frames": sess.latency_frames,
        }

    def stream_push(self, sid, body):
        sess = self.sessions.get(sid)
        if sess is None:
            raise KeyError(f"unknown session {sid}")
        if "frames" not in body:
            raise ValueError("missing required field 'frames'")
        return {"poses": sess.push(np.asarray(body["frames"], np.float32)).tolist()}

    def stream_flush(self, sid):
        sess = self.sessions.pop(sid, None)
        if sess is None:
            raise KeyError(f"unknown session {sid}")
        return {"poses": sess.flush().tolist()}

    def stream_close(self, sid):
        """Discard a session without flushing (an abandoned client)."""
        if self.sessions.pop(sid, None) is None:
            raise KeyError(f"unknown session {sid}")
        return {"closed": sid}

    # ------------------------------------------------------------------
    def handle(self, method, path, body):
        """Route one request; returns (status, payload dict)."""
        try:
            if method == "GET" and path == "/healthz":
                return 200, self.healthz()
            if method == "POST" and path == "/predict":
                return 200, self.predict(body)
            if method == "POST" and path == "/stream/open":
                return 200, self.stream_open(body)
            parts = path.strip("/").split("/")
            if method == "POST" and len(parts) == 3 and parts[0] == "stream":
                sid, op = parts[1], parts[2]
                if op == "push":
                    return 200, self.stream_push(sid, body)
                if op == "flush":
                    return 200, self.stream_flush(sid)
                if op == "close":
                    return 200, self.stream_close(sid)
            return 404, {"error": f"no route {method} {path}"}
        except KeyError as e:
            return 404, {"error": str(e)}
        except (ValueError, RuntimeError, TypeError) as e:
            return 400, {"error": str(e)}


# One JSON body must fit in memory: 64 MiB holds ~500k frames of float
# keypoints; a larger one is a client's fault and must not exhaust the
# single-threaded server's memory.
MAX_BODY_BYTES = 64 << 20


def make_http_server(server: PoseServer, host: str, port: int) -> HTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def _respond(self, status, payload):
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _body(self):
            n = int(self.headers.get("Content-Length") or 0)
            if not n:
                return {}
            if n > MAX_BODY_BYTES:
                return None
            try:
                return json.loads(self.rfile.read(n))
            except json.JSONDecodeError:
                return None

        def do_GET(self):
            self._respond(*server.handle("GET", self.path, {}))

        def do_POST(self):
            body = self._body()
            if body is None:
                self._respond(400, {"error": "invalid or oversized JSON body"})
                return
            self._respond(*server.handle("POST", self.path, body))

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return HTTPServer((host, port), Handler)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8035)
    ap.add_argument("--checkpoint", default="",
                    help=".pth (reference format) or a run directory of the port")
    ap.add_argument("--tag", default="best_val")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--no-tta", action="store_true")
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--data-parallel", action="store_true")
    ap.add_argument("--max-sessions", type=int, default=64)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    httpd = make_http_server(
        PoseServer(build_predictor(args), max_sessions=args.max_sessions),
        args.host, args.port,
    )
    print(f"serving on http://{args.host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
