"""`scripts.serve` under `--seq-parallel`'s ranks, on a stub pipeline over 2
gloo processes (tests/torch_parallel_worker.py --serve): rank 0 serves HTTP
and broadcasts each batch's call to rank 1, whose part shows in the answer
(the stub sums the ranks' index + 1); a request the handler or the pipeline
refuses fails alone and the ranks serve on; when rank 1 dies in a call,
rank 0's collective fails and both processes end with a non-zero exit,
within the test's bound (a hung rank would fail it, not wait). The two
tests share one pair of processes, in this order."""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import base64
import io
import json
import os
import queue
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")


def _post(url, payload):
    req = urllib.request.Request(url + "/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _answered_by_both_ranks(url):
    status, got = _post(url, {"prompt": "a small cactus"})
    assert status == 200, got
    latents = np.load(io.BytesIO(base64.b64decode(got["images"][0])))
    return latents.shape == (2, 2, 4) and np.all(latents == 3.0)  # 1 + 2: both ranks ran


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    env = dict(os.environ)
    env.pop("MASTER_ADDR", None)
    store = tmp_path_factory.mktemp("serve") / "store"
    procs = [subprocess.Popen([sys.executable, WORKER, "--serve", str(store), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in (0, 1)]
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in procs[0].stdout],
                     daemon=True).start()
    try:
        url = None
        while url is None:
            line = lines.get(timeout=120)
            if line.startswith("serving on "):
                url = line.split()[2]
        yield url, procs
    finally:
        for p in procs:
            p.kill()


def test_a_refused_request_fails_alone_and_the_ranks_serve_on(ranks):
    url, procs = ranks
    assert _answered_by_both_ranks(url)
    for bad in ({"prompt": "x", "sampler": "nope"}, {"prompt": "x", "steps": 0},
                {"prompt": "x", "height": 12}, {"prompt": "x", "width": -16}):
        status, got = _post(url, bad)
        assert status == 400 and "bad request" in got["error"], (bad, status, got)
    status, got = _post(url, {"prompt": "refuse"})  # the pipeline's own check
    assert status == 500 and "refused" in got["error"], got
    assert _answered_by_both_ranks(url)
    assert [p.poll() for p in procs] == [None, None]


def test_rank0_answers_and_a_dying_rank_ends_the_run(ranks):
    url, procs = ranks
    assert _answered_by_both_ranks(url)
    try:
        _post(url, {"prompt": "die"})
    except (urllib.error.URLError, ConnectionError):
        pass  # a 500, or the connection closed as rank 0 ends
    codes = [p.wait(timeout=120) for p in procs]
    assert codes == [1, 3], codes
