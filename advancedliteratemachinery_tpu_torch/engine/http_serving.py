"""HTTP deployment surface over the continuous-batching engine (port of
`advancedliteratemachinery_tpu/engine/http_serving.py`).

A stdlib `ThreadingHTTPServer` where every request thread submits into one
`ContinuousBatcher` (`engine/serving.py`), so concurrent clients coalesce
into fixed-shape recognizer forwards on the card.

Endpoints:
  GET  /healthz        → {"ok": true, "model": ..., "device": ...}
  GET  /v1/stats       → batcher counters (batches, items, padded_slots)
  POST /v1/recognize   → one word crop → {"text", "confidence", "head"}
  POST /v1/read        → full page → {"words": [{"text", "confidence",
                          "det_score", "quad"}, ...]} (detector + batched
                          recognition)

Bodies: raw image bytes (PNG or `.npy`, decoded by
`pipelines/file_loading.py` without PIL), or JSON `{"image_b64": "..."}`,
of at most MAX_BODY_BYTES (a larger one is refused, 413, unread). Word
crops go into the batcher as they were decoded; each batch goes up to the
engine's device and is resized there to the recognizer's shape at once
(`ops/image.py` `resize_each_u8`: cv2's INTER_LINEAR). A page's quads are
rectified and resized together on the engine's device, and their crops
stay there.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from concurrent.futures import Future
from typing import Callable, List, Optional

import numpy as np
import torch

from advancedliteratemachinery_tpu_torch.engine.serving import (
    ContinuousBatcher)
from advancedliteratemachinery_tpu_torch.ops.image import (
    as_device_tensor, crop_quads_u8, resize_each_u8)
from advancedliteratemachinery_tpu_torch.pipelines.file_loading import (
    decode_image)


# the largest request body read
MAX_BODY_BYTES = 64 << 20


def _decode_image(body: bytes, content_type: str) -> np.ndarray:
    """Request body → RGB uint8 [H, W, 3]."""
    if "json" in (content_type or ""):
        payload = json.loads(body.decode("utf-8"))
        body = base64.b64decode(payload["image_b64"])
    return decode_image(body)


class _DeepBacklogServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog sized for bursty load: the
    stdlib default `request_queue_size = 5` resets connections when more
    than a handful of clients connect in the same accept window."""

    request_queue_size = 128
    daemon_threads = True


class CropBatcher(ContinuousBatcher):
    """The server's batcher: word crops of any size (uint8 [h, w, 3],
    NumPy arrays or tensors on any device) go in as they are; each batch is
    resized to `crop_hw` on `device` in one pass (`resize_each_u8`), zero
    rows padding it to `batch_size`, and handed to `infer_fn` there."""

    def __init__(self, infer_fn: Callable, batch_size: int, crop_hw,
                 device: torch.device, max_wait_ms: float = 5.0):
        super().__init__(infer_fn, batch_size, (*crop_hw, 3),
                         max_wait_ms=max_wait_ms)
        self.device = device

    def submit(self, item) -> Future:
        if item.ndim != 3 or item.shape[-1] != 3 or 0 in item.shape:
            raise ValueError(f"crop must be [h, w, 3]; got "
                             f"{tuple(item.shape)}")
        fut: Future = Future()
        self._q.put((item, fut))
        return fut

    def _batch(self, items: List) -> torch.Tensor:
        return resize_each_u8(items, self.item_shape[:2], self.device,
                              self.batch_size)


class RecognitionHTTPServer:
    """Serve a recognition engine (and optional detector) over HTTP.

    engine: an `engine/infer.py` inference object with
    `recognize(images_u8) -> [(text, conf, head), ...]` over crops of
    `crop_hw`, as uint8 tensors on its `device`, which it must have.
    detect_fn: optional `image -> (quads [N, 8] or [N, 4, 2], scores)`
    (`models/db.py` `make_db_detect_fn`) enabling `/v1/read`."""

    def __init__(self, engine, *, crop_hw=(32, 128), batch_size: int = 32,
                 max_wait_ms: float = 5.0, host: str = "127.0.0.1",
                 port: int = 8000,
                 detect_fn: Optional[Callable] = None,
                 model_name: str = "mgp_str"):
        self.engine = engine
        self.crop_hw = tuple(crop_hw)
        self.detect_fn = detect_fn
        self.model_name = model_name
        if getattr(engine, "device", None) is None:
            raise ValueError(f"{type(engine).__name__} has no `device`: the "
                             f"server resizes crops on the engine's device")
        self.device = torch.device(engine.device)
        self.batcher = CropBatcher(engine.recognize, batch_size,
                                   self.crop_hw, self.device,
                                   max_wait_ms=max_wait_ms)
        self._httpd = _DeepBacklogServer((host, port),
                                         self._make_handler())
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    # ---- request handling ----

    def _recognize_one(self, image: np.ndarray) -> dict:
        text, conf, head = self.batcher.submit(image).result()
        return {"text": text, "confidence": round(float(conf), 4),
                "head": head}

    def _read_page(self, image: np.ndarray) -> dict:
        if self.detect_fn is None:
            raise ValueError("server started without a detector; "
                             "/v1/read unavailable")
        quads, scores = self.detect_fn(image)
        crops = crop_quads_u8(as_device_tensor(image, self.device),
                              np.asarray(quads, np.float32).reshape(-1, 4, 2),
                              self.crop_hw)
        futs = [self.batcher.submit(c) for c in crops]
        words = []
        for q, s, f in zip(quads, scores, futs):
            text, conf, head = f.result()
            words.append({"text": text, "confidence": round(float(conf), 4),
                          "det_score": round(float(s), 4),
                          "quad": np.asarray(q).round(1).tolist()})
        return {"words": words}

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # _send always emits Content-Length, so HTTP/1.1 keep-alive
            # is safe: each client holds one connection across requests
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet; stats live in /v1/stats
                pass

            def _send(self, code: int, obj: dict) -> None:
                data = json.dumps(obj).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {
                        "ok": True, "model": server.model_name,
                        "device": server.device.type})
                elif self.path == "/v1/stats":
                    self._send(200, dict(server.batcher.stats))
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path not in ("/v1/recognize", "/v1/read"):
                    self._send(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    n = -1
                if not 0 <= n <= MAX_BODY_BYTES:
                    self.close_connection = True
                    self._send(413, {"error": f"body of {n} bytes: at most "
                                              f"{MAX_BODY_BYTES}"})
                    return
                body = self.rfile.read(n)
                try:
                    image = _decode_image(
                        body, self.headers.get("Content-Type", ""))
                    if self.path == "/v1/recognize":
                        self._send(200, server._recognize_one(image))
                    else:
                        self._send(200, server._read_page(image))
                except Exception as e:  # surface the cause to the client
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})

        return Handler

    # ---- lifecycle ----

    def start(self) -> "RecognitionHTTPServer":
        self.batcher.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.batcher.stop()

    def serve_forever(self) -> None:
        """Foreground mode for the CLI."""
        self.batcher.start()
        try:
            self._httpd.serve_forever()
        finally:
            self.stop()
