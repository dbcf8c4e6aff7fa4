"""txt2img serving: an HTTP JSON API with micro-batching.

Port of scripts/serve.py: a dependency-free HTTP server (the standard
library's `http.server`) in front of `PixArtPipeline`, whose batcher groups
concurrent requests of one signature into one CFG-batched trajectory, padded
to a fixed batch size.

API:
  GET  /                     -> a minimal browser page
  GET  /healthz              -> {"status": "ok", ...}
  POST /generate  {"prompt": "...", "steps": 20, "cfg_scale": 4.5,
                   "seed": 0, "height": 1024, "width": 1024,
                   "sampler": "dpm-solver"}
    -> {"images": ["<base64 png>", ...], "decoded": true, "batched_with": N}
    Accepts a single prompt or a list. Images are PNG when the pipeline has
    a VAE, otherwise float latents as base64 .npy. A full queue answers 429
    with Retry-After.

Run on the card (a `.pth` checkpoint; `--turbo` turns on int8 and block
caching at interval 2):

    python -m pixart_sigma_tpu_torch.scripts.serve \\
        --config configs/pixart_sigma_config/PixArt_sigma_xl2_img1024_serving_turbo.py \\
        --model-path model.pth --pseudo-t5 4096 --vae-path sdxl_vae.safetensors --port 8000

and on the CPU with `--device cpu` and a small config.

`--seq-parallel N` splits each trajectory's tokens over N ranks (sequence
parallelism, `PixArtPipeline(mesh=)`), one process per rank under torchrun:

    torchrun --nproc-per-node N -m pixart_sigma_tpu_torch.scripts.serve \
        --seq-parallel N --config ... --model-path model.pth --pseudo-t5 4096

(a world of W ranks splits the batch over W / N data groups besides). Rank 0
runs the HTTP server and the batcher and broadcasts each batch's call to the
other ranks, which run it with it; rank 0 answers. A request the pipeline
would refuse is answered 400 (`check_opts`), and a call it refuses fails
for its batch alone, on rank 0 before the broadcast (`RankedPipe`). A call
that fails once broadcast, or a rank that fails, ends the run with a
non-zero exit: the others' collectives fail on its closed connections, and
idle ranks hear a heartbeat within the group's timeout (`RANK_TIMEOUT`), so
no rank waits forever.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import math
import queue
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _Request:
    def __init__(self, prompt, opts):
        self.prompt = prompt
        self.opts = opts
        self.event = threading.Event()
        self.result = None
        self.error = None


class ServerBusyError(Exception):
    """Queue depth limit reached: callers should return 429."""


class MicroBatcher:
    """Groups compatible requests into one pipeline call.

    Requests are compatible when their signature (H, W, steps, cfg_scale,
    sampler) matches. The batch is padded to the next size in `batch_sizes`
    by repeating the last prompt.

    Admission control: at most `queue_depth` requests may be in flight
    (enqueued or being generated); `submit_many` admits all of a request's
    prompts or raises ServerBusyError, which the HTTP layer maps to 429 +
    Retry-After.

    Fairness: the scheduler serves the eligible group (a full batch, or past
    `max_wait`) with the oldest waiting request first, so a rare signature
    behind a sustained stream of another waits at most one batch plus
    `max_wait`.

    Per-request seeds: each row's initial latent is the one the pipeline
    draws for a solo B = 1 call with that seed, so a batched request
    reproduces its served-alone image. Stochastic samplers draw their
    per-step noise for the whole batch, so they batch only with requests of
    the same seed.
    """

    def __init__(self, pipe, y_null_row=None, max_wait_ms: int = 25,
                 batch_sizes=(1, 2, 4, 8, 12), max_batch: int = 12,
                 queue_depth: int = 64, gen_kwargs=None):
        self.pipe = pipe
        self.y_null_row = y_null_row
        # server-wide pipeline kwargs (block_cache_interval for the turbo
        # preset), not part of the request signature
        self.gen_kwargs = dict(gen_kwargs or {})
        self.max_wait = max_wait_ms / 1000.0
        self.batch_sizes = sorted(batch_sizes)
        self.max_batch = max_batch
        self.queue_depth = queue_depth
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self.q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit_async(self, prompt, opts):
        """Enqueue without blocking; returns the request handle for wait()."""
        return self.submit_many([prompt], opts)[0]

    def submit_many(self, prompts, opts):
        """Atomically admit a list of prompts (all or none -> 429)."""
        n = len(prompts)
        with self._inflight_lock:
            if self._inflight + n > self.queue_depth:
                raise ServerBusyError(
                    f"queue full ({self._inflight} in flight + {n} requested "
                    f"> limit {self.queue_depth})")
            self._inflight += n
        reqs = [_Request(p, opts) for p in prompts]
        for req in reqs:
            self.q.put(req)
        return reqs

    def _finish(self, reqs):
        with self._inflight_lock:
            self._inflight -= len(reqs)
        for r in reqs:
            r.event.set()

    def wait(self, req, timeout=600.0):
        if not req.event.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def submit(self, prompt, opts, timeout=600.0):
        return self.wait(self.submit_async(prompt, opts), timeout)

    def shutdown(self):
        self._stop.set()
        self.q.put(None)
        self.thread.join(timeout=600.0)

    # samplers whose trajectory draws per-step noise for the whole batch: a
    # request's output would depend on its batch position, so those batch
    # only with same-seed requests
    _STOCHASTIC = frozenset({"sde-dpm-solver", "sa-solver", "iddpm", "lcm"})

    def _sig(self, req):
        o = req.opts
        sig = (o["height"], o["width"], o["steps"], o["cfg_scale"], o["sampler"])
        if o["sampler"] in self._STOCHASTIC:
            sig += (o["seed"],)
        return sig

    def _latent_hw(self, o):
        height, width = o["height"], o["width"]
        if not self.pipe.model.cfg.multi_scale and height != width:
            height = width = self.pipe.base_resolution  # the pipeline snaps too
        return height // 8, width // 8

    def _loop(self):
        pending: dict = {}  # sig -> [(req, arrival_time), ...]
        while not self._stop.is_set():
            timeout = None
            if pending:
                oldest = min(g[0][1] for g in pending.values())
                timeout = max(0.0, oldest + self.max_wait - time.time())
            try:
                req = self.q.get(timeout=timeout)
                if req is not None:
                    pending.setdefault(self._sig(req), []).append((req, time.time()))
            except queue.Empty:
                pass
            # drain whatever else is queued before choosing a batch
            while True:
                try:
                    nxt = self.q.get_nowait()
                except queue.Empty:
                    break
                if nxt is not None:
                    pending.setdefault(self._sig(nxt), []).append((nxt, time.time()))
            now = time.time()
            for sig in sorted(pending, key=lambda s: pending[s][0][1]):  # oldest group first
                group = pending[sig]
                if len(group) >= self.max_batch or now - group[0][1] >= self.max_wait:
                    rest = group[self.max_batch:]
                    batch = [r for r, _ in group[: self.max_batch]]
                    if rest:
                        pending[sig] = rest
                    else:
                        del pending[sig]
                    self._run(batch)
                    break  # re-check the queue between batches

    def _run(self, batch):
        try:
            import torch

            prompts = [r.prompt for r in batch]
            n = len(prompts)
            padded = next((s for s in self.batch_sizes if s >= n), self.max_batch)
            prompts = prompts + [prompts[-1]] * (padded - n)
            o = batch[0].opts
            dev = self.pipe.device
            h, w = self._latent_hw(o)
            rows = [
                torch.randn((1, h, w, 4), device=dev, dtype=torch.float32,
                            generator=torch.Generator(device=dev).manual_seed(int(r.opts["seed"])))
                for r in batch
            ]
            rows += [rows[-1]] * (padded - n)
            kwargs = {"latents": torch.cat(rows, dim=0)}
            if self.y_null_row is not None:
                kwargs["y_null"] = self.y_null_row[None].expand(len(prompts),
                                                                *self.y_null_row.shape)
            gen = dict(self.gen_kwargs)
            if o["sampler"] != "dpm-solver":
                # block caching is dpm-solver only; other samplers run exact
                # under --turbo rather than fail
                gen.pop("block_cache_interval", None)
            out = self.pipe(
                prompts, height=o["height"], width=o["width"], num_inference_steps=o["steps"],
                guidance_scale=o["cfg_scale"], sampler=o["sampler"], seed=o["seed"],
                **gen, **kwargs)
            for i, r in enumerate(batch):
                r.result = (out[i], len(batch))
            self._finish(batch)
        except Exception as e:  # noqa: BLE001 - surfaced per request
            for r in batch:
                r.error = e
            self._finish(batch)


def _encode_image(arr, decoded: bool) -> str:
    buf = io.BytesIO()
    if decoded:
        from PIL import Image

        Image.fromarray(arr).save(buf, format="PNG")
    else:
        import numpy as np

        np.save(buf, arr)
    return base64.b64encode(buf.getvalue()).decode()


_INDEX_HTML = """<!doctype html>
<title>PixArt-Sigma</title>
<style>body{font-family:sans-serif;max-width:720px;margin:2em auto}
img{max-width:100%%;margin:4px;border-radius:6px}
input,select{margin:2px}textarea{width:100%%}</style>
<h2>PixArt-Sigma</h2>
<form id=f>
<textarea name=prompt rows=2
 placeholder="a small cactus with a happy face">%(example)s</textarea><br>
steps <input name=steps type=number value=20 size=3>
cfg <input name=cfg_scale type=number step=0.5 value=4.5 size=3>
seed <input name=seed type=number value=0 size=4>
sampler <select name=sampler><option>dpm-solver<option>sa-solver
<option>iddpm<option>lcm<option>dmd</select>
<button>generate</button> <span id=s></span></form><div id=out></div>
<script>
f.onsubmit = async (e) => {
  e.preventDefault(); s.textContent = "generating...";
  const d = Object.fromEntries(new FormData(f));
  d.steps = +d.steps; d.cfg_scale = +d.cfg_scale; d.seed = +d.seed;
  const r = await fetch("/generate", {method: "POST", body: JSON.stringify(d)});
  const j = await r.json(); s.textContent = r.ok ? "" : (j.error || r.status);
  if (r.ok) out.innerHTML = j.images.map(
    b => j.decoded ? `<img src="data:image/png;base64,${b}">`
                   : "<pre>(no VAE: latents returned)</pre>").join("");
};
</script>"""


# the largest side and step count a request may ask for
MAX_SIDE = 4096
MAX_STEPS = 1000


def check_opts(opts: dict, samplers) -> dict:
    """`opts` of a request, or ValueError (a 400) for what the pipeline
    would refuse or could not run: an unknown sampler, steps outside 1 to
    MAX_STEPS, a side that is not a positive multiple of 16 up to MAX_SIDE,
    a guidance scale that is not finite."""
    if opts["sampler"] not in samplers:
        raise ValueError(f"sampler must be one of {', '.join(samplers)}")
    if not 1 <= opts["steps"] <= MAX_STEPS:
        raise ValueError(f"steps must be 1 to {MAX_STEPS}")
    for side in ("height", "width"):
        if not (0 < opts[side] <= MAX_SIDE and opts[side] % 16 == 0):
            raise ValueError(f"{side} must be a multiple of 16 from 16 to {MAX_SIDE}")
    if not math.isfinite(opts["cfg_scale"]):
        raise ValueError("cfg_scale must be finite")
    return opts


def make_handler(batcher, pipe, info):
    decoded = pipe.vae is not None

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet access log
            pass

        def _send(self, code, body: bytes, content_type: str, headers=()):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            for name, value in headers:
                self.send_header(name, value)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code, payload, headers=()):
            self._send(code, json.dumps(payload).encode(), "application/json", headers)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, dict(status="ok", inflight=batcher._inflight,
                                     queue_depth=batcher.queue_depth, **info))
            elif self.path in ("/", "/index.html"):
                body = _INDEX_HTML % {"example": "a small cactus with a happy face"}
                self._send(200, body.encode(), "text/html; charset=utf-8")
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                prompts = req.get("prompt", "")
                prompts = [prompts] if isinstance(prompts, str) else list(prompts)
                if not prompts or not all(isinstance(p, str) for p in prompts):
                    raise ValueError("prompt must be a string or a non-empty list of strings")
                opts = check_opts(dict(
                    height=int(req.get("height", info["resolution"])),
                    width=int(req.get("width", info["resolution"])),
                    steps=int(req.get("steps", 20)),
                    cfg_scale=float(req.get("cfg_scale", 4.5)),
                    sampler=str(req.get("sampler", "dpm-solver")),
                    seed=int(req.get("seed", 0)),
                ), pipe.SAMPLERS)
            except Exception as e:  # noqa: BLE001
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                # all of a request's prompts are admitted together, so they
                # can share a micro-batch
                reqs = batcher.submit_many(prompts, opts)
                results = [batcher.wait(r) for r in reqs]
            except ServerBusyError as e:
                self._json(429, {"error": str(e)}, headers=(("Retry-After", "5"),))
                return
            except Exception as e:  # noqa: BLE001
                self._json(500, {"error": str(e)})
                return
            self._json(200, {
                "images": [_encode_image(r[0], decoded) for r in results],
                "decoded": decoded,
                "batched_with": max(r[1] for r in results),
            })

    return Handler


# seconds a rank waits in one collective before it fails (and the run ends);
# idle ranks hear rank 0's heartbeat (`RankedPipe`) far sooner
RANK_TIMEOUT = 600.0


def add_seq_parallel_args(p) -> None:
    p.add_argument("--seq-parallel", type=int, default=0, metavar="N",
                   help="shard the token dim over N ranks per trajectory (run under torchrun)")


def seq_mesh(args, device):
    """The ("data", "fsdp", "tensor", "seq") mesh of `--seq-parallel N`
    (`MeshConfig(data=-1, seq=N)`, as the JAX entry points build it) over
    torchrun's ranks (or the process group already initialised), or None
    without the flag."""
    if not (args.seq_parallel and args.seq_parallel > 1):
        return None
    from pixart_sigma_tpu_torch.parallel.dist import initialize_distributed
    from pixart_sigma_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    if not initialize_distributed(device=device, timeout=RANK_TIMEOUT):
        raise RuntimeError(f"--seq-parallel {args.seq_parallel} runs one process per rank: "
                           f"start it under torchrun --nproc-per-node {args.seq_parallel}")
    return build_mesh(MeshConfig(data=-1, seq=args.seq_parallel), device.type)


def _to_cpu(kwargs: dict) -> dict:
    import torch

    return {k: v.cpu() if torch.is_tensor(v) else v for k, v in kwargs.items()}


class RankedPipe:
    """Rank 0's pipeline when every rank runs each call: the call (prompts
    and arguments, tensors on the host) is broadcast to the other ranks
    (`follow`) before rank 0 runs it, and while idle a heartbeat is
    broadcast every `heartbeat_s`, so the others wait in no collective
    longer than that.

    A call the pipeline refuses (`check_call`, which `__call__` runs before
    any collective, alike on every rank) is refused here, before the
    broadcast: it fails for its batch and no rank runs it. A call that
    fails once broadcast may leave the ranks at different collectives, so
    it, like a heartbeat that fails (a rank died), is kept in `failed` and
    `on_failure` is called."""

    def __init__(self, pipe, heartbeat_s: float = 10.0, on_failure=None):
        self.pipe = pipe
        self.failed = None
        self.on_failure = on_failure
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._beat = threading.Thread(target=self._heartbeat, args=(heartbeat_s,), daemon=True)
        self._beat.start()

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def _send(self, msg):
        from pixart_sigma_tpu_torch.parallel.dist import broadcast_object

        try:
            broadcast_object(msg)
        except Exception as e:  # noqa: BLE001
            self._fail(e)
            raise

    def _fail(self, e):
        if self.failed is None:
            self.failed = e
            if self.on_failure is not None:
                self.on_failure()

    def __call__(self, prompts, **kwargs):
        kwargs = _to_cpu(kwargs)
        with self._lock:
            if self.failed is not None:
                raise RuntimeError(f"a rank failed: {self.failed}")
            self.pipe.check_call(prompts, **kwargs)
            self._send(("call", list(prompts), kwargs))
            try:
                return self.pipe(prompts, **kwargs)
            except Exception as e:  # noqa: BLE001
                self._fail(e)
                raise

    def _heartbeat(self, period: float):
        while not self._stop.wait(period):
            with self._lock:
                if self.failed is not None:
                    return
                try:
                    self._send(("heartbeat",))
                except Exception:  # noqa: BLE001
                    return

    def close(self):
        self._stop.set()
        with self._lock:
            if self.failed is None:
                self._send(("stop",))


def follow(pipe) -> None:
    """A rank other than 0: run every call rank 0 broadcasts, until it
    stops."""
    from pixart_sigma_tpu_torch.parallel.dist import broadcast_object

    while True:
        msg = broadcast_object(None)
        if msg[0] == "stop":
            return
        if msg[0] == "call":
            pipe(msg[1], **msg[2])


def load_encoders(args, model, scale: float, device):
    """(text encoder, its null-caption row or None, VAE) from the flags:
    `--pseudo-t5 DIM` conditions on the model's learned null caption, as the
    JAX entry points do; `--vae-flax` is a `scripts.train_vae` directory,
    `--vae-path` a diffusers `.safetensors`."""
    t5 = y_null_row = vae = None
    if args.pseudo_t5:
        from pixart_sigma_tpu_torch.models.t5 import PseudoT5Embedder

        t5 = PseudoT5Embedder(args.pseudo_t5, model.cfg.model_max_length)
        y_null_row = model.y_embedder.y_embedding.detach().float()
    elif args.t5_path:
        from pixart_sigma_tpu_torch.models.t5 import T5Embedder

        t5 = T5Embedder.from_pretrained(args.t5_path,
                                        model_max_length=model.cfg.model_max_length,
                                        device=device)
    if args.vae_flax:
        from pixart_sigma_tpu_torch.models.vae import load_flax_vae

        vae = load_flax_vae(args.vae_flax, device=device)
    elif args.vae_path:
        from pixart_sigma_tpu_torch.models.vae import VAEConfig, load_diffusers_vae

        vae = load_diffusers_vae(args.vae_path, VAEConfig.sdxl(scaling_factor=scale),
                                 device=device)
    return t5, y_null_row, vae


def build_pipeline(args):
    """(pipeline, null-caption row, resolution, config) from the flags; with
    `--seq-parallel` every rank builds it over the mesh."""
    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.models.builder import build_model_from_config
    from pixart_sigma_tpu_torch.pipelines import PixArtPipeline
    from pixart_sigma_tpu_torch.utils.checkpoint import load_checkpoint
    from pixart_sigma_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    mesh = seq_mesh(args, device)
    config = read_config(args.config)
    overrides = {}
    if args.int8 or args.turbo:
        overrides["quant_int8"] = True
    wants_cache = (args.turbo or (args.block_cache_interval or 0) >= 2
                   or config.get("block_cache_interval", 0) >= 2)
    if wants_cache and not config.get("cache_span"):
        # block caching needs the span in the model, else the first
        # dpm-solver request would fail
        overrides["cache_span"] = (7, 21)
    model = build_model_from_config(config, device=device, **overrides)
    load_checkpoint(args.model_path, model, load_ema=args.load_ema)
    res = config.get("image_size", 1024)
    scale = args.scale_factor or config.get("scale_factor", 0.13025)
    t5, y_null_row, vae = load_encoders(args, model, scale, device)
    pipe = PixArtPipeline(model, t5=t5, vae=vae, scale_factor=scale, base_resolution=res,
                          device=device, mesh=mesh)
    return pipe, y_null_row, res, config


def server_settings(args, config) -> dict:
    """The batcher's gen_kwargs: block caching at the flag's interval, else
    2 under --turbo, else the config's `block_cache_interval`."""
    interval = (args.block_cache_interval if args.block_cache_interval is not None
                else (2 if args.turbo else config.get("block_cache_interval", 0)))
    return {"block_cache_interval": interval} if interval >= 2 else {}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PixArt-Sigma HTTP server with micro-batching")
    p.add_argument("--config", required=True)
    p.add_argument("--model-path", required=True,
                   help="an upstream-dialect .pth, a diffusers .safetensors, or a JAX run's "
                        "orbax step_N, checkpoints/ or run directory")
    p.add_argument("--load-ema", action="store_true")
    p.add_argument("--t5-path", default=None, help="a local HF T5 encoder directory")
    p.add_argument("--pseudo-t5", type=int, default=None, metavar="DIM")
    p.add_argument("--vae-path", default=None, help="a diffusers VAE .safetensors")
    p.add_argument("--vae-flax", default=None,
                   help="a VAE directory of scripts.train_vae (vae_config.json + "
                        "vae_params.msgpack)")
    p.add_argument("--scale-factor", type=float, default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=12, help="largest micro-batch")
    p.add_argument("--queue-depth", type=int, default=64,
                   help="max in-flight requests before /generate returns 429")
    p.add_argument("--int8", action="store_true",
                   help="dynamic int8 (W8A8) projection and MLP matmuls")
    p.add_argument("--max-wait-ms", type=int, default=25)
    add_seq_parallel_args(p)
    p.add_argument("--turbo", action="store_true",
                   help="int8 W8A8 + delta block caching at interval 2")
    p.add_argument("--block-cache-interval", type=int, default=None,
                   help="delta block caching refresh interval (>= 2)")
    p.add_argument("--warmup", action="store_true",
                   help="run one default request before serving")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def serve(pipe, args, y_null_row=None, gen_kwargs=None, info=None) -> int:
    """Serve `pipe` over HTTP until interrupted; returns the exit code.
    Under a process group (`--seq-parallel`) rank 0 serves and the other
    ranks follow its calls; a failed rank makes it 1."""
    from pixart_sigma_tpu_torch.parallel.dist import process_count, process_index

    if process_index() > 0:
        try:
            follow(pipe)
        except Exception:  # noqa: BLE001 - the run ends, not this rank alone
            traceback.print_exc()
            return 1
        return 0
    res = pipe.base_resolution
    server = None
    ranked = process_count() > 1
    if ranked:
        pipe = RankedPipe(pipe, on_failure=lambda: threading.Thread(
            target=lambda: server is not None and server.shutdown(), daemon=True).start())
    batch_ranks = getattr(pipe, "batch_ranks", 1)
    batcher = MicroBatcher(pipe, y_null_row=y_null_row, max_wait_ms=args.max_wait_ms,
                           batch_sizes=tuple(sorted({-(-b // batch_ranks) * batch_ranks
                                                     for b in (1, 2, 4, 8, 12)})),
                           max_batch=args.max_batch, queue_depth=args.queue_depth,
                           gen_kwargs=gen_kwargs)
    if args.warmup:
        batcher.submit("warmup", dict(height=res, width=res, steps=20, cfg_scale=4.5,
                                      sampler="dpm-solver", seed=0))
        print("warmup done", flush=True)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(batcher, pipe, info or {"resolution": res}))
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(max_batch={args.max_batch})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        batcher.shutdown()
        if ranked and pipe.failed is None:
            pipe.close()
    if ranked and pipe.failed is not None:
        print(f"a rank failed, ending the run: {pipe.failed}", file=sys.stderr, flush=True)
        return 1
    return 0


def main(argv=None):
    args = parse_args(argv)
    pipe, y_null_row, res, config = build_pipeline(args)
    gen_kwargs = server_settings(args, config)
    info = {"resolution": res, "model": args.model_path, "turbo": bool(gen_kwargs)}
    sys.exit(serve(pipe, args, y_null_row, gen_kwargs, info))


if __name__ == "__main__":
    main()
