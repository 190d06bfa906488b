"""HTTP serving front end over the continuous batcher: port of
`kivi_tpu/serving/api.py` over `kivi_tpu_torch.serving.batcher`.

A dependency-free (stdlib ``http.server``) network API.  One stepper
thread drives ``ContinuousBatcher.step()``, so every launch on the
device comes from one thread; HTTP handler threads only enqueue
requests and wait on per-request queues/events, so concurrent
connections share the batcher's slots through continuous batching.

Endpoints (JSON in, JSON out; token ids, not text — tokenization is the
client's concern):

  POST /v1/generate   {"prompt": [int, ...], "max_new_tokens": int,
                       "temperature"?, "top_k"?, "top_p"?,
                       "repetition_penalty"?, "eos_token_id"?,
                       "stream"?: bool, "prefix"?: [int, ...]}
    "prefix" needs a prefix cache, which comes with a later slice of the
    port: such a request gets 400, as the JAX server answers one when it
    was built without a prefix cache.
    stream=false → {"uid": int, "tokens": [int, ...]}
    stream=true  → Server-Sent Events: one `data: {"token": t}` per
                   generated token as it decodes, closed by
                   `data: [DONE]`.
  GET /v1/health      {"status": "ok"|"error", "error", "active_slots",
                       "queued"} — lock-free reads, so health stays
                       responsive through a long prefill.

A rejected request (prompt + max_new_tokens does not fit the cache)
returns its uid with an empty token list / an immediate [DONE], as
``ContinuousBatcher`` records it.  A streaming client that disconnects
mid-generation has its request cancelled (the slot frees for queued
traffic).  Delivered results are pruned immediately.
"""

from __future__ import annotations

import itertools
import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kivi_tpu_torch.serving.batcher import (ContinuousBatcher, Request,
                                            Result)

_DONE = object()


class ServingAPI:
    """Owns the batcher, the stepper thread, and the HTTP server.

    Use as a context manager or call start()/close().  `port=0` binds an
    ephemeral port (read it back from `.port` — the test harness does).
    """

    def __init__(self, batcher: ContinuousBatcher, host: str = "127.0.0.1",
                 port: int = 0):
        self.batcher = batcher
        self._lock = threading.Lock()        # guards batcher + registry
        self._uids = itertools.count()
        self._streams: dict[int, queue.Queue] = {}
        self._events: dict[int, threading.Event] = {}
        self._results: dict[int, Result] = {}   # completed, unconsumed
        self._stop = threading.Event()
        # set when the stepper hits an unrecoverable exception: pending
        # requests are failed (empty results), new ones get 503, and
        # /v1/health reports the error — instead of the alternative
        # (dead stepper thread, every handler blocked forever)
        self.error: str | None = None
        api = self

        class Handler(BaseHTTPRequestHandler):
            # quiet: BaseHTTPRequestHandler logs every request to stderr
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                if self.path != "/v1/health":
                    self.send_error(404)
                    return
                # deliberately lock-free: the stepper may hold _lock
                # through a long prefill, and an orchestrator's health
                # probe must not time out behind it (GIL makes these
                # int/len reads safe, merely ~one tick stale)
                body = json.dumps({
                    "status": "error" if api.error else "ok",
                    "error": api.error,
                    "active_slots": int(api.batcher.active.sum()),
                    "queued": len(api.batcher.queue),
                }).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path != "/v1/generate":
                    self.send_error(404)
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    spec = json.loads(self.rfile.read(n))
                    fields = dict(
                        prompt=[int(t) for t in spec["prompt"]],
                        max_new_tokens=int(spec["max_new_tokens"]),
                        eos_token_id=(None
                                      if spec.get("eos_token_id") is None
                                      else int(spec["eos_token_id"])),
                        temperature=float(spec.get("temperature", 0.0)),
                        top_k=int(spec.get("top_k", 0)),
                        top_p=float(spec.get("top_p", 1.0)),
                        repetition_penalty=float(
                            spec.get("repetition_penalty", 1.0)),
                        prefix_tokens=([int(t) for t in spec["prefix"]]
                                       if spec.get("prefix") else None))
                    stream = bool(spec.get("stream", False))
                except (KeyError, ValueError, TypeError,
                        json.JSONDecodeError) as e:
                    self.send_error(400, explain=str(e))
                    return
                q: queue.Queue = queue.Queue()
                ev = threading.Event()
                # register + submit atomically with the error check:
                # the stepper sets error and sweeps waiters under this
                # same lock, so a request is either swept or refused
                with api._lock:
                    if api.error is not None:
                        uid = None
                    else:
                        uid = next(api._uids)
                        try:
                            api.batcher.submit(Request(
                                uid=uid,
                                on_token=q.put if stream else None,
                                **fields))
                        except (ValueError, NotImplementedError) as e:
                            self.send_error(400, explain=str(e))
                            return
                        if stream:
                            api._streams[uid] = q
                        api._events[uid] = ev
                if uid is None:
                    self.send_error(503, explain=api.error)
                    return
                if stream:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    try:
                        while True:
                            tok = q.get()
                            if tok is _DONE:
                                break
                            self.wfile.write(
                                f"data: {json.dumps({'token': tok})}\n\n"
                                .encode())
                            self.wfile.flush()
                        self.wfile.write(b"data: [DONE]\n\n")
                    except OSError:
                        # client went away mid-stream: cancel so the
                        # slot stops burning device time
                        with api._lock:
                            api.batcher.cancel(uid)
                            api.batcher.results.pop(uid, None)
                            api._streams.pop(uid, None)
                            api._events.pop(uid, None)
                            api._results.pop(uid, None)
                else:
                    ev.wait()
                    with api._lock:
                        res = api._results.pop(uid, None)
                    toks = res.tokens if res is not None else []
                    body = json.dumps({"uid": uid,
                                       "tokens": toks}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._threads: list[threading.Thread] = []

    def _deliver(self):
        """Move finished batcher results to their waiters and PRUNE —
        call with _lock held.  Server memory stays O(in-flight), not
        O(all-time requests)."""
        done = [u for u in self.batcher.results
                if u in self._streams or u in self._events]
        for u in done:
            res = self.batcher.results.pop(u)
            if u in self._streams:
                self._streams.pop(u).put(_DONE)
                self._events.pop(u, None)
            else:
                self._results[u] = res
                self._events.pop(u).set()

    def _fail_pending(self):
        """Fail every registered, undelivered request — call with _lock
        held (stepper error sweep and close())."""
        for u in set(self._streams) | set(self._events):
            self.batcher.results.setdefault(u, Result(u, []))
        self._deliver()

    def _stepper(self):
        """The ONE thread that drives the device: admit/decode/retire,
        then fan completion out to waiting handler threads.  A step
        exception fails every in-flight request (empty Result) and
        flips the server into 503 mode rather than hanging clients."""
        while not self._stop.is_set():
            with self._lock:
                idle = not (self.batcher.queue or self.batcher.active.any())
                if not idle:
                    try:
                        self.batcher.step()
                        self.batcher._retire()   # deliver, no 1-step lag
                    except Exception as e:       # noqa: BLE001
                        self.error = repr(e)
                        self._fail_pending()
                        return
                self._deliver()
            if idle:
                self._stop.wait(0.005)
        with self._lock:
            self._fail_pending()     # close(): unblock in-flight waiters

    def start(self) -> "ServingAPI":
        for fn in (self._stepper, self._httpd.serve_forever):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def close(self):
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        for t in self._threads:
            t.join(timeout=10)
        with self._lock:
            self._fail_pending()     # stepper may have died on error

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
