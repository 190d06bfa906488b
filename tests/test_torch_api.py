"""The port's HTTP serving front end (kivi_tpu_torch.serving.api, CPU)
over its continuous batcher, mirroring tests/test_api.py.

Wire-protocol checks on a tiny random-weight model: non-streaming JSON
responses are token-equal to driving a fresh batcher directly (greedy),
SSE streaming delivers the same tokens one event at a time, concurrent
connections share the slot pool, and malformed or unservable requests
(a "prefix", which needs the prefix cache of a later slice) get 4xx
instead of wedging the stepper.
"""

import http.client
import json
import threading

import numpy as np
import pytest
import torch

from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.models import modeling
from kivi_tpu_torch.serving.api import ServingAPI
from kivi_tpu_torch.serving.batcher import ContinuousBatcher, Request

torch.set_num_threads(2)

CFG = tiny_config()
QCFG = QuantConfig(k_bits=2, v_bits=2, group_size=32, residual_length=32)
PARAMS = modeling.init_params(CFG, seed=0, dtype=torch.float32, device="cpu")


def _batcher():
    return ContinuousBatcher(CFG, QCFG, PARAMS, num_slots=2,
                             max_seq_len=256, device="cpu",
                             prompt_buckets=(32,))


def _post(port, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=120)
    conn.request("POST", "/v1/generate", json.dumps(payload),
                 {"Content-Type": "application/json"})
    return conn, conn.getresponse()


@pytest.fixture(scope="module")
def api():
    with ServingAPI(_batcher()) as srv:
        yield srv


def _prompt(seed, n=12):
    return [int(t) for t in
            np.random.default_rng(seed).integers(1, CFG.vocab_size, n)]


def test_generate_matches_direct_batcher(api):
    prompt = _prompt(0)
    conn, resp = _post(api.port, {"prompt": prompt, "max_new_tokens": 8})
    assert resp.status == 200
    got = json.loads(resp.read())["tokens"]
    conn.close()
    want = _batcher().run([Request(uid=0, prompt=prompt,
                                   max_new_tokens=8)])[0].tokens
    assert got == want


def test_stream_sse_tokens(api):
    prompt = _prompt(1)
    conn, resp = _post(api.port, {"prompt": prompt, "max_new_tokens": 6,
                                  "stream": True})
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    toks = []
    for raw in resp:
        line = raw.decode().strip()
        if not line.startswith("data: "):
            continue
        if line == "data: [DONE]":
            break
        toks.append(json.loads(line[6:])["token"])
    conn.close()
    want = _batcher().run([Request(uid=0, prompt=prompt,
                                   max_new_tokens=6)])[0].tokens
    assert toks == want


def test_concurrent_requests_share_slots(api):
    prompts = [_prompt(10 + i) for i in range(3)]
    out = [None] * 3

    def go(i):
        conn, resp = _post(api.port, {"prompt": prompts[i],
                                      "max_new_tokens": 5})
        out[i] = json.loads(resp.read())["tokens"]
        conn.close()

    threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for i in range(3):
        want = _batcher().run([Request(uid=0, prompt=prompts[i],
                                       max_new_tokens=5)])[0].tokens
        assert out[i] == want


def test_rejected_request_returns_empty(api):
    # prompt bucket + max_new_tokens exceeds the 256-slot cache
    conn, resp = _post(api.port, {"prompt": _prompt(2),
                                  "max_new_tokens": 10_000})
    assert json.loads(resp.read())["tokens"] == []
    conn.close()


def test_stream_disconnect_cancels_request():
    """Closing the SSE socket mid-stream frees the slot (the request
    stops decoding) and the server keeps serving."""
    import time

    bat = _batcher()
    with ServingAPI(bat) as srv:
        conn, resp = _post(srv.port, {"prompt": _prompt(23),
                                      "max_new_tokens": 240,
                                      "stream": True})
        resp.fp.readline()             # first SSE event is flowing
        resp.close()                   # client goes away mid-stream
        conn.close()
        for _ in range(200):           # poll until the cancel lands
            if not bat.active.any():
                break
            time.sleep(0.05)
        assert not bat.active.any()
        conn, resp = _post(srv.port, {"prompt": _prompt(24),
                                      "max_new_tokens": 3})
        assert len(json.loads(resp.read())["tokens"]) == 3
        conn.close()
        assert bat.results == {} and srv._results == {}  # pruned


def test_bad_field_types_get_400():
    with ServingAPI(_batcher()) as srv:
        for payload in ({"prompt": [1], "max_new_tokens": 2,
                         "temperature": "hot"},
                        {"prompt": 5, "max_new_tokens": 2},
                        {"prompt": [1], "max_new_tokens": 2,
                         "eos_token_id": "stop"}):
            conn, resp = _post(srv.port, payload)
            assert resp.status == 400, payload
            conn.close()


def test_close_unblocks_inflight_waiters():
    import threading as th

    bat = _batcher()
    srv = ServingAPI(bat).start()
    got = {}

    def go():
        conn, resp = _post(srv.port, {"prompt": _prompt(25),
                                      "max_new_tokens": 230})
        got["body"] = json.loads(resp.read())
        conn.close()

    t = th.Thread(target=go)
    t.start()
    import time
    time.sleep(2.0)                    # request is mid-decode
    srv.close()
    t.join(timeout=30)
    assert not t.is_alive()
    assert "tokens" in got["body"]     # returned (partial/empty), no hang


def test_step_exception_fails_pending_and_503s():
    """A step() exception must fail in-flight requests (empty tokens)
    and flip the server to 503 + error health — never hang clients."""
    bat = _batcher()
    orig_admit = bat._admit
    calls = {"n": 0}

    def boom():
        calls["n"] += 1
        if calls["n"] >= 2:          # let the first request admit, then die
            raise RuntimeError("injected step failure")
        orig_admit()

    with ServingAPI(bat) as srv:
        bat._admit = boom
        conn, resp = _post(srv.port, {"prompt": _prompt(5),
                                      "max_new_tokens": 50})
        body = json.loads(resp.read())
        conn.close()
        assert body["tokens"] == [] or len(body["tokens"]) < 50
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=30)
        conn.request("GET", "/v1/health")
        health = json.loads(conn.getresponse().read())
        conn.close()
        assert health["status"] == "error"
        assert "injected step failure" in health["error"]
        conn, resp = _post(srv.port, {"prompt": _prompt(6),
                                      "max_new_tokens": 2})
        assert resp.status == 503
        conn.close()


def test_prefix_without_cache_is_400():
    """The port has no prefix cache yet: a "prefix" gets the 400 the JAX
    server gives when it was built without one."""
    with ServingAPI(_batcher()) as srv:
        conn, resp = _post(srv.port, {"prompt": _prompt(9), "prefix": [1],
                                      "max_new_tokens": 2})
        assert resp.status == 400
        conn.close()


def test_bad_requests_get_4xx_and_health(api):
    conn, resp = _post(api.port, {"max_new_tokens": 4})   # no prompt
    assert resp.status == 400
    conn.close()
    conn = http.client.HTTPConnection("127.0.0.1", api.port,
                                      timeout=30)
    conn.request("GET", "/nope")
    assert conn.getresponse().status == 404
    conn.close()
    conn = http.client.HTTPConnection("127.0.0.1", api.port,
                                      timeout=30)
    conn.request("GET", "/v1/health")
    health = json.loads(conn.getresponse().read())
    assert health["status"] == "ok"
    conn.close()
