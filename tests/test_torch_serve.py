"""The port's serving entry points on the CPU: the micro-batcher, the HTTP
server in-process on a loopback port, and the batch inference CLI.

- The batcher (a stand-in pipeline that records its calls): signature
  grouping, stochastic samplers grouped only with the same seed, padding to
  `batch_sizes`, `gen_kwargs` outside the signature and `block_cache_interval`
  dropped for samplers other than dpm-solver, the oldest eligible group
  first, and 429 backpressure with atomic admission.
- Per-request seeds: a batch of requests reproduces each request's solo
  pipeline call (the same initial latent) within 1e-5 relative L2 (readings
  about 2e-7: the batched products sum in another order), and a row drawn
  from another seed is far off (readings 1.3 to 1.4).
- The HTTP round trip with a toy `.pth` written by `state_dict_from_jax`
  from JAX params: GET /, /healthz, 404, 400, POST /generate (latents as
  .npy) equal to the direct pipeline call within 1e-5, and 429 with
  Retry-After under `--queue-depth 2`; `--turbo` builds int8 and block
  caching at interval 2.
- `inference.py` on a two-line prompt file writes `.npy` latents equal to
  the pipeline's calls with seed + index within 1e-5.
- The turbo config reads through the port's config reader as through JAX's;
  `--seq-parallel 2` outside torchrun, the refusals of an orbax path and the card default
  without a card (`--vae-flax` is read since the VAE trainer came:
  `tests/test_torch_toy_workflow.py`).
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import base64
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.config import read_config as jax_read_config
from pixart_sigma_tpu.data.aspect import get_chunks as jax_get_chunks
from pixart_sigma_tpu.models.builder import build_model_from_config as jax_build_model
from pixart_sigma_tpu.models.builder import model_kwargs_from_config as jax_model_kwargs
from pixart_sigma_tpu_torch.config import read_config
from pixart_sigma_tpu_torch.data.aspect import get_chunks
from pixart_sigma_tpu_torch.models.builder import build_model_from_config, model_kwargs_from_config
from pixart_sigma_tpu_torch.models.layers import QuantLinear
from pixart_sigma_tpu_torch.scripts import inference, serve
from pixart_sigma_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_safetensors,
    state_dict_from_jax,
    torch_to_diffusers_state_dict,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURBO = os.path.join(REPO, "configs/pixart_sigma_config/PixArt_sigma_xl2_img1024_serving_turbo.py")
TOY_BASE = os.path.join(REPO, "configs/toy/pixart_toy_img128.py")
REL_TOL = 1e-5  # relative L2 of latents against the direct pipeline call (readings ~2e-7)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel(got, want) <= REL_TOL, _rel(got, want)


# ---------------------------------------------------------------- the batcher

class _FakeCfg:
    multi_scale = True


class _FakeModel:
    cfg = _FakeCfg()


class _FakePipe:
    """Stands in for PixArtPipeline: sleeps per call, records each call."""

    def __init__(self, delay=0.05):
        self.model = _FakeModel()
        self.base_resolution = 256
        self.device = torch.device("cpu")
        self.vae = None
        self.delay = delay
        self.calls = []
        self.lock = threading.Lock()

    def __call__(self, prompts, **kw):
        with self.lock:
            self.calls.append((list(prompts), kw))
        time.sleep(self.delay)
        return np.zeros((len(prompts), 4, 4, 4), np.float32)


def _opts(steps=2, seed=0, sampler="dpm-solver"):
    return dict(height=64, width=64, steps=steps, cfg_scale=4.5, sampler=sampler, seed=seed)


def test_batcher_groups_by_signature_and_pads():
    pipe = _FakePipe(delay=0.01)
    b = serve.MicroBatcher(pipe, max_wait_ms=300, max_batch=4, batch_sizes=(1, 2, 4),
                           gen_kwargs={"block_cache_interval": 2})
    try:
        reqs = [b.submit_async(f"d{i}", _opts(seed=i)) for i in range(3)]
        reqs += [b.submit_async("other steps", _opts(steps=3))]
        reqs += [b.submit_async(f"s{i}", _opts(seed=i % 2, sampler="sa-solver"))
                 for i in range(3)]
        results = [b.wait(r, timeout=30) for r in reqs]
    finally:
        b.shutdown()
    calls = {(kw["num_inference_steps"], kw["sampler"], kw["seed"]): (p, kw)
             for p, kw in pipe.calls}
    assert len(pipe.calls) == 4
    # three dpm-solver requests of one signature, padded to 4 with the last
    prompts, kw = calls[(2, "dpm-solver", 0)]
    assert prompts == ["d0", "d1", "d2", "d2"] and kw["block_cache_interval"] == 2
    assert tuple(kw["latents"].shape) == (4, 8, 8, 4)
    assert [r[1] for r in results[:4]] == [3, 3, 3, 1]
    # the stochastic sampler batches only same-seed requests; no caching
    prompts, kw = calls[(2, "sa-solver", 0)]
    assert prompts == ["s0", "s2"] and "block_cache_interval" not in kw
    assert calls[(2, "sa-solver", 1)][0] == ["s1"]


def test_batcher_queue_depth_backpressure():
    pipe = _FakePipe(delay=0.3)
    b = serve.MicroBatcher(pipe, max_wait_ms=50, max_batch=2, batch_sizes=(1, 2),
                           queue_depth=3)
    try:
        reqs = [b.submit_async(f"p{i}", _opts(seed=i)) for i in range(3)]
        with pytest.raises(serve.ServerBusyError):
            b.submit_async("overflow", _opts())
        with b._inflight_lock:
            before = b._inflight
        with pytest.raises(serve.ServerBusyError):  # all or nothing
            b.submit_many(["a", "b", "c", "d"], _opts())
        with b._inflight_lock:
            assert b._inflight == before
        for r in reqs:
            b.wait(r, timeout=30)
        b.wait(b.submit_async("after", _opts()), timeout=30)  # capacity came back
    finally:
        b.shutdown()


def test_batcher_rare_signature_not_starved_behind_hot_stream():
    pipe = _FakePipe(delay=0.08)
    b = serve.MicroBatcher(pipe, max_wait_ms=20, max_batch=2, batch_sizes=(1, 2),
                           queue_depth=1000)
    stop = threading.Event()
    hot = []

    def flood():
        while not stop.is_set():
            hot.append(b.submit_async("hot", _opts(steps=2)))
            time.sleep(0.01)

    flooder = threading.Thread(target=flood, daemon=True)
    try:
        flooder.start()
        time.sleep(0.2)
        t0 = time.time()
        b.wait(b.submit_async("rare", _opts(steps=7)), timeout=10)
        latency = time.time() - t0
        stop.set()
        flooder.join(timeout=5)
        # one batch in flight plus max_wait plus its own batch, with slack;
        # starvation would run into the 10 s timeout
        assert latency < 2.0, latency
        steps = [kw["num_inference_steps"] for _, kw in pipe.calls]
        assert 7 in steps and steps.count(2) > 3
        for r in hot:
            b.wait(r, timeout=30)
    finally:
        stop.set()
        b.shutdown()


# ---------------------------------------------------------------- a toy model

def _toy_config(tmp_path, **extra):
    lines = [f"_base_ = [{TOY_BASE!r}]",
             "model = 'PixArtMS_XL_2'",
             "model_overrides = dict(depth=4, hidden_size=64, num_heads=2, caption_channels=32)",
             "model_max_length = 16", "mixed_precision = 'fp32'", "cache_span = (1, 3)"]
    lines += [f"{k} = {v!r}" for k, v in extra.items()]
    path = tmp_path / "toy_serve.py"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def toy_files(tmp_path_factory):
    """A toy config and a `.pth` of perturbed JAX params in the upstream
    names, through `state_dict_from_jax`."""
    tmp = tmp_path_factory.mktemp("serve")
    config = _toy_config(tmp)
    jm = jax_build_model(jax_read_config(config))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
                              jnp.zeros((1, 16, 32)), jnp.ones((1, 16), jnp.int32))["params"]
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
    model = build_model_from_config(read_config(config), device="cpu")
    sd = state_dict_from_jax(params, model.cfg)
    ema = {k: v + 0.01 for k, v in sd.items()}
    pth = str(tmp / "toy.pth")
    torch.save({"state_dict": sd, "state_dict_ema": ema}, pth)
    return config, pth, sd, ema


def _serve_args(config, pth, *extra):
    return serve.parse_args(["--config", config, "--model-path", pth, "--pseudo-t5", "32",
                             "--device", "cpu", *extra])


def _solo(pipe, y_null_row, prompt, seed, steps=3, **kw):
    y_null = y_null_row[None].expand(1, *y_null_row.shape)
    return pipe([prompt], height=128, width=128, num_inference_steps=steps, seed=seed,
                y_null=y_null, **kw)[0]


def test_batched_rows_reproduce_solo_calls(toy_files):
    config, pth, _, _ = toy_files
    pipe, y_null_row, res, _ = serve.build_pipeline(_serve_args(config, pth))
    assert res == 128 and pipe.device == torch.device("cpu")
    b = serve.MicroBatcher(pipe, y_null_row=y_null_row, max_wait_ms=500, max_batch=4,
                           batch_sizes=(1, 2, 4))
    opts = lambda seed: dict(height=128, width=128, steps=3, cfg_scale=4.5,
                             sampler="dpm-solver", seed=seed)
    try:
        reqs = [b.submit_async(f"a prompt number {i}", opts(10 + i)) for i in range(3)]
        results = [b.wait(r, timeout=120) for r in reqs]
    finally:
        b.shutdown()
    assert [n for _, n in results] == [3, 3, 3]
    for i, (got, _) in enumerate(results):
        want = _solo(pipe, y_null_row, f"a prompt number {i}", 10 + i)
        assert got.shape == (16, 16, 4)
        _close(got, want)
    # the planted fault: request 0's row drawn from request 1's seed
    other = _solo(pipe, y_null_row, "a prompt number 0", 11)
    assert _rel(other, results[0][0]) > 0.5


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post(url, payload):
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    return _get(req)


class _Server:
    """The port's server in-process on a loopback port chosen by the OS."""

    def __init__(self, args):
        self.pipe, self.y_null_row, res, config = serve.build_pipeline(args)
        gen_kwargs = serve.server_settings(args, config)
        self.info = {"resolution": res, "model": args.model_path, "turbo": bool(gen_kwargs)}
        self.batcher = serve.MicroBatcher(
            self.pipe, y_null_row=self.y_null_row, max_wait_ms=args.max_wait_ms,
            max_batch=args.max_batch, queue_depth=args.queue_depth, gen_kwargs=gen_kwargs)
        self.httpd = ThreadingHTTPServer(
            ("127.0.0.1", 0), serve.make_handler(self.batcher, self.pipe, self.info))
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.shutdown()


def _latents(b64):
    return np.load(io.BytesIO(base64.b64decode(b64)))


def test_http_round_trip(toy_files):
    config, pth, _, _ = toy_files
    server = _Server(_serve_args(config, pth, "--max-wait-ms", "300"))
    try:
        status, headers, body = _get(server.url + "/healthz")
        health = json.loads(body)
        assert status == 200 and health["status"] == "ok" and health["resolution"] == 128
        assert health["turbo"] is False
        status, headers, body = _get(server.url + "/")
        assert status == 200 and headers["Content-Type"].startswith("text/html")
        assert b"/generate" in body
        assert _get(server.url + "/nope")[0] == 404
        assert _post(server.url + "/nope", {})[0] == 404
        assert _post(server.url + "/generate", b"{not json")[0] == 400
        assert _post(server.url + "/generate", {"prompt": [1, 2]})[0] == 400
        out = [None, None]

        def call(i):
            out[i] = _post(server.url + "/generate",
                           {"prompt": f"request {i}", "steps": 3, "seed": 5 + i})

        threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i, (status, _, body) in enumerate(out):
            reply = json.loads(body)
            assert status == 200 and reply["decoded"] is False and reply["batched_with"] == 2
            got = _latents(reply["images"][0])
            want = _solo(server.pipe, server.y_null_row, f"request {i}", 5 + i)
            _close(got, want)
    finally:
        server.close()


def test_http_429_and_turbo(toy_files):
    config, pth, _, _ = toy_files
    server = _Server(_serve_args(config, pth, "--queue-depth", "2", "--turbo"))
    try:
        assert server.info["turbo"] and server.batcher.gen_kwargs == {"block_cache_interval": 2}
        assert isinstance(server.pipe.model.blocks[0].mlp.fc1, QuantLinear)
        status, headers, body = _post(server.url + "/generate",
                                      {"prompt": ["a", "b", "c"], "steps": 3})
        assert status == 429 and headers["Retry-After"] == "5"
        assert "queue full" in json.loads(body)["error"]
        status, _, body = _post(server.url + "/generate", {"prompt": ["a", "b"], "steps": 3})
        reply = json.loads(body)
        assert status == 200 and len(reply["images"]) == 2 and reply["batched_with"] == 2
        want = _solo(server.pipe, server.y_null_row, "a", 0, block_cache_interval=2)
        _close(_latents(reply["images"][0]), want)
    finally:
        server.close()


# ---------------------------------------------------------------- the CLI

def test_inference_cli_writes_latents(toy_files, tmp_path):
    config, pth, _, _ = toy_files
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a red fox in the snow\n\na lighthouse at dusk --ar 1:1\n")
    out = tmp_path / "out"
    inference.main(["--config", config, "--model-path", pth, "--txt-file", str(prompts),
                    "--save-root", str(out), "--pseudo-t5", "32", "--steps", "3", "--seed", "7",
                    "--device", "cpu"])
    files = sorted(os.listdir(out))
    assert files == ["00000_dpm-solver_3.jpg.npy", "00001_dpm-solver_3.jpg.npy"]
    pipe, y_null_row, _, _ = serve.build_pipeline(_serve_args(config, pth))
    for i, (name, prompt) in enumerate(zip(files, ["a red fox in the snow",
                                                   "a lighthouse at dusk --ar 1:1"])):
        _close(np.load(out / name), _solo(pipe, y_null_row, prompt, 7 + i))


def test_load_checkpoint_reads_pth_and_ema(toy_files, tmp_path):
    config, pth, sd, ema = toy_files
    model = build_model_from_config(read_config(config), device="cpu")
    load_checkpoint(pth, model)
    assert torch.equal(model.blocks[1].attn.qkv.weight, sd["blocks.1.attn.qkv.weight"])
    load_checkpoint(pth, model, load_ema=True)
    assert torch.equal(model.blocks[1].attn.qkv.weight, ema["blocks.1.attn.qkv.weight"])
    # a diffusers transformer file of the same weights
    path = save_safetensors(str(tmp_path / "x.safetensors"), torch_to_diffusers_state_dict(sd))
    fresh = load_checkpoint(path, build_model_from_config(read_config(config), device="cpu"))
    assert torch.equal(fresh.blocks[1].attn.qkv.weight, sd["blocks.1.attn.qkv.weight"])


def test_turbo_config_reads_as_in_jax():
    config, jconfig = read_config(TURBO), jax_read_config(TURBO)
    assert config["quant_int8"] is True and config["cache_span"] == (7, 21)
    assert config["block_cache_interval"] == 2 and config["image_size"] == 1024
    got, want = model_kwargs_from_config(config), jax_model_kwargs(jconfig)
    assert {k: v for k, v in got.items() if k != "dtype"} == \
        {k: v for k, v in want.items() if k != "dtype"}
    assert got["quant_int8"] and got["cache_span"] == (7, 21)
    args = serve.parse_args(["--config", TURBO, "--model-path", "x.pth"])
    assert serve.server_settings(args, config) == {"block_cache_interval": 2}
    assert model_kwargs_from_config(config, quant_int8=False, cache_span=None)["cache_span"] \
        is None
    assert list(get_chunks(list(range(7)), 3)) == list(jax_get_chunks(list(range(7)), 3))


def test_entry_points_refuse_what_the_port_does_not_run(toy_files, tmp_path):
    config, pth, _, _ = toy_files
    prompts = tmp_path / "p.txt"
    prompts.write_text("a\n")
    cli = ["--model-path", pth, "--txt-file", str(prompts), "--config", config,
           "--save-root", str(tmp_path / "o"), "--device", "cpu"]
    for extra, match in ((["--seq-parallel", "2"], "under torchrun --nproc-per-node 2"),):
        with pytest.raises(RuntimeError, match=match):
            serve.build_pipeline(_serve_args(config, pth, *extra))
        with pytest.raises(RuntimeError, match=match):
            inference.main(cli + extra)
    orbax = tmp_path / "checkpoints" / "step_10"  # an orbax directory without its files
    orbax.mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="_CHECKPOINT_METADATA"):
        serve.build_pipeline(_serve_args(config, str(orbax)))
    with pytest.raises(FileNotFoundError, match="_CHECKPOINT_METADATA"):
        inference.main([*cli[:0], "--model-path", str(orbax), *cli[2:]])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.build_pipeline(serve.parse_args(["--config", config, "--model-path", pth]))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            inference.main(cli[:-2])
