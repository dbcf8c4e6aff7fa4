"""One rank of a multi-rank run of the port over gloo, for the tests of
tests/test_torch_parallel_*.py. It imports torch and the port only.

    python tests/torch_parallel_worker.py SPEC.json RANK
    python tests/torch_parallel_worker.py --serve STORE RANK

SPEC holds "world" (1: no process group), "store" (the file of the
file:// rendezvous), "out" (a torch.save path, per rank: "{rank}" in it)
and "runs", a list of runs done in order in the same process group:

- {"kind": "trainer", "config": {...}, "work_dir": ..., "steps": N}: a
  Trainer on a config made from the 1024px KV-compress config, cut to a
  tiny f32 model, with the spec's keys over it; trains N steps.
- {"kind": "step", "weights": .npz, "batch": .npz, "config": {...}}: one
  `train_step` with CAME behind a clip and the EMA, from the weights and the
  global batch's draws of the file (t, noise, drop).
- {"kind": "collectives"}: `parallel.dist`'s helpers on small inputs.
- {"kind": "seq_ops", "inputs": .npz}: seqshard and ring attention,
  masked and not, on this rank's token shard of q, k, v (and the mask),
  forward and backward against the cotangent's shard.
- {"kind": "seq_forward", "weights": .npz, "inputs": .npz, "config": {...}}:
  a model forward with its tokens over the world's ranks.
- {"kind": "seq_pipeline", "weights": .npz, "inputs": .npz, "config": {...},
  "mesh": {...}}: `PixArtPipeline(mesh=)`, plain and with the adaptive
  block cache, with the cache-span layers' calls counted.
- {"kind": "seq_traps"}: the output gather's gradient, the ring shift, the
  block cache's drift over ranks holding different rows.

Each run records, gathered whole: the parameters, the EMA and the per-step
metrics, and this rank's bytes of parameters, optimizer state and EMA
against their replicated total; a Trainer run also the optimizer state,
the LR schedule's position (`opt_step`) and the calls of `parallel.dist`'s
collectives (`TRANSPORTS`).
"""

import contextlib
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIGMA_1024 = os.path.join(
    ROOT, "configs/pixart_sigma_config/PixArt_sigma_xl2_img1024_internalms_kvcompress.py")
TINY = dict(depth=2, hidden_size=128, num_heads=4, caption_channels=64, kv_compress_layers=(1,))


def tiny_config(data_root, **overrides):
    """The 1024px KV-compress config cut to a tiny f32 model at 256px."""
    from pixart_sigma_tpu_torch.config import read_config

    cfg = read_config(SIGMA_1024)
    cfg.update(image_size=256, aspect_ratio_type=256, train_batch_size=2, data_root=data_root,
               num_workers=1, log_interval=1, mixed_precision="fp32", seed=3,
               lr_schedule_args=dict(num_warmup_steps=0), save_model_steps=0,
               save_model_epochs=10**6, model_overrides=dict(TINY))
    cfg.data = dict(cfg.data, root="data", load_vae_feat=True, load_t5_feat=True)
    cfg.optimizer = dict(cfg.optimizer, lr=0.02)  # x 0.125 by auto_lr at a global batch of 4
    overrides = dict(overrides)
    cfg.model_overrides = dict(cfg.model_overrides, **overrides.pop("model_overrides", {}))
    cfg.update(overrides)
    return cfg


@contextlib.contextmanager
def one_thread():
    """torch on one thread, as in the worker processes: a tiny model runs
    faster so (4.4 s against 11.3 s with 8 threads for a 3-step Trainer
    run), and the test processes beside it keep their cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def write_data(root, n=12):
    """n feature items of the 256px square bucket under root/data."""
    from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset

    write_feature_dataset(os.path.join(str(root), "data"), [(256, 256)] * n, resolution=256,
                          caption_channels=TINY["caption_channels"])
    return str(root)


def _bytes(state, full_optimizer):
    """(this rank's bytes of parameters, optimizer state and EMA; their
    replicated total, with the optimizer's `full_state_dict`)."""
    from pixart_sigma_tpu_torch.parallel.sharded import local

    params = list(state.model.parameters())
    mine = sum(local(p).nelement() * local(p).element_size() for p in params)
    total = sum(p.nelement() * p.element_size() for p in params)
    mine += sum(e.nelement() * e.element_size() for e in state.ema.values())
    total += sum(p.nelement() * p.element_size() for p in params)
    for st in state.optimizer.state.values():
        mine += sum(v.nelement() * v.element_size() for v in st.values()
                    if torch.is_tensor(v) and v.ndim)
    for st in full_optimizer["state"].values():
        total += sum(v.nelement() * v.element_size() for v in st.values()
                     if torch.is_tensor(v) and v.ndim)
    return mine, total


def _param_names(state):
    """The names of the optimizer's parameters, in the order of its state's
    keys."""
    names = {p: n for n, p in state.model.named_parameters()}
    return [names[p] for g in state.optimizer.param_groups for p in g["params"]]


def _whole(state):
    from pixart_sigma_tpu_torch.parallel.sharded import full_state, local

    named = dict(state.model.named_parameters())
    params = full_state(((n, local(p)) for n, p in named.items()), named)
    return params, state.full_ema()


def run_trainer(run):
    from pixart_sigma_tpu_torch.parallel.dist import TRANSPORTS
    from pixart_sigma_tpu_torch.training.trainer import Trainer

    cfg = tiny_config(run["data_root"], **run.get("config", {}))
    TRANSPORTS.clear()
    with one_thread():
        trainer = Trainer(cfg, run["work_dir"], device="cpu")
        trainer.train(max_steps=run["steps"])
    params, ema = _whole(trainer.state)
    optimizer = trainer.state.optimizer.full_state_dict()
    mine, total = _bytes(trainer.state, optimizer)
    sampler = trainer.schedule_sampler
    return dict(params=params, ema=ema, history=[
        {k: v for k, v in h.items() if k != "seconds"} for h in trainer.history],
        bytes=mine, total_bytes=total, batch_rank=trainer.batch_rank,
        sampler=None if sampler is None else sampler.state_dict(),
        optimizer=optimizer, opt_step=trainer.state.opt_step, transports=dict(TRANSPORTS),
        optimizer_names=_param_names(trainer.state))


def run_step(run):
    from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
    from pixart_sigma_tpu_torch.models.builder import build_model_from_config
    from pixart_sigma_tpu_torch.models.pixart import set_seq_parallel
    from pixart_sigma_tpu_torch.parallel import mesh as mesh_lib
    from pixart_sigma_tpu_torch.training.optim import block_stacks, build_optimizer
    from pixart_sigma_tpu_torch.training.train_state import TrainState
    from pixart_sigma_tpu_torch.training.train_step import train_step

    cfg = tiny_config("", **run.get("config", {}))
    model = build_model_from_config(cfg, device="cpu", train=True)
    weights = {k: torch.from_numpy(v) for k, v in np.load(run["weights"]).items()}
    model.load_state_dict(weights)
    data = {k: torch.from_numpy(v) for k, v in np.load(run["batch"]).items()}
    forward, sync, group, ranks, rank, seq = model, (), None, 1, 0, None
    if torch.distributed.is_initialized():
        mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(**cfg.mesh), "cpu")
        group = mesh_lib.batch_group(mesh)
        forward, sync = mesh_lib.shard_model(model, mesh, fsdp=cfg.get("use_fsdp", False),
                                             tensor=cfg.get("use_tensor_parallel", False),
                                             min_size=cfg.get("fsdp_min_size", 2**16),
                                             batch_group=group)
        ranks, rank = mesh_lib.batch_ranks(mesh), mesh_lib.batch_rank(mesh)
        seq = mesh_lib.seq_context(mesh)
        set_seq_parallel(model, seq)
    named = list(model.named_parameters())
    stacks = block_stacks([n for n, _ in named], model.cfg.block_groups())
    optimizer = build_optimizer(named, name="came", lr=0.0, stacks=stacks)
    state = TrainState(model, optimizer, lambda step: run["lr"], ema=True,
                       ema_rate=run["ema_rate"])
    state.forward, state.sync_params = forward, [p for p in model.parameters() if p in sync]
    state.batch_group, state.batch_ranks, state.batch_rank = group, ranks, rank
    state.seq_group = None if seq is None else seq.group
    B = data["latents"].shape[0] // state.batch_ranks
    rows = slice(state.batch_rank * B, (state.batch_rank + 1) * B)
    batch = {k: data[k][rows] for k in ("latents", "y", "y_mask")}
    diffusion = IDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)
    with one_thread():
        metrics = train_step(state, diffusion, batch, t=data["t"].long(), noise=data["noise"],
                             force_drop_ids=data["drop"], grad_clip=run["clip"])
    params, ema = _whole(state)
    return dict(params=params, ema=ema, history=[metrics])


def run_collectives(run):
    """`all_gather_tensor` forward and backward (rank r holds r + [0, 1, 2]
    and weighs the gathered rows by (r + 1)), `reduce_dict`, `gather_cpu`,
    `broadcast_object`."""
    from pixart_sigma_tpu_torch.parallel import dist as pdist

    r = pdist.process_index()
    x = (torch.arange(3.0) + r).reshape(1, 3).requires_grad_(True)
    gathered = pdist.all_gather_tensor(x, dim=0)
    (gathered * (r + 1) * torch.arange(1.0, gathered.shape[0] + 1)[:, None]).sum().backward()
    return dict(gathered=gathered.detach(), grad=x.grad,
                reduced=pdist.reduce_dict({"a": torch.tensor(float(r)),
                                           "b": torch.tensor(2.0 * r)}),
                objects=pdist.gather_cpu({"rank": r}),
                broadcast=pdist.broadcast_object({"from": r}))


def _seq_world():
    from pixart_sigma_tpu_torch.parallel.mesh import SeqContext

    return SeqContext(torch.distributed.group.WORLD, torch.distributed.get_world_size(),
                      torch.distributed.get_rank())


def tiny_seq_model(weights, config):
    """The tiny f32 PixArt of `config` (PixArtConfig fields) with the
    weights of the .npz (`state_dict_from_jax`)."""
    from pixart_sigma_tpu_torch.models.pixart import PixArt, PixArtConfig

    model = PixArt(PixArtConfig(**dict(config, dtype=torch.float32))).float().eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in np.load(weights).items()})
    return model


def run_seq_ops(run):
    from pixart_sigma_tpu_torch.ops.attention import ring_attention, seq_sharded_attention

    seq = _seq_world()
    data = {k: torch.from_numpy(v) for k, v in np.load(run["inputs"]).items()}
    out = {}
    for name, fn in (("seqshard", seq_sharded_attention), ("ring", ring_attention)):
        for masked in (False, True):
            q, k, v = (seq.shard(data[n]).clone().requires_grad_(True) for n in "qkv")
            mask = seq.shard(data["mask"]) if masked else None
            got = fn(q, k, v, seq=seq, key_mask=mask)
            (got * seq.shard(data["cot"])).sum().backward()
            out[(name, masked)] = [got.detach(), q.grad, k.grad, v.grad]
    return out


def run_seq_forward(run):
    from pixart_sigma_tpu_torch.models.pixart import set_seq_parallel

    model = tiny_seq_model(run["weights"], run["config"])
    set_seq_parallel(model, _seq_world())
    data = np.load(run["inputs"])
    x, t, y, mask = (torch.from_numpy(data[k]) for k in ("x", "t", "y", "mask"))
    with torch.no_grad():
        return model(x, t, y, mask)


def run_seq_pipeline(run):
    """The mesh pipeline's latents, plain and cached, and how often each
    call ran the cached span's first block."""
    from pixart_sigma_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from pixart_sigma_tpu_torch.pipelines import PixArtPipeline

    model = tiny_seq_model(run["weights"], run["config"])
    mesh = build_mesh(MeshConfig(**run["mesh"]), "cpu")
    pipe = PixArtPipeline(model, base_resolution=256, device="cpu", mesh=mesh)
    data = {k: torch.from_numpy(v) for k, v in np.load(run["inputs"]).items()}
    kw = dict(height=64, width=64, num_inference_steps=4, y=data["y"], y_mask=data["y_mask"],
              y_null=data["y_null"], latents=data["latents"], return_latents=True)
    calls = []
    k1 = model.cfg.cache_span[0]
    model.blocks[k1].register_forward_hook(lambda *a: calls.append(1))
    plain = pipe(["a", "b"], **kw)
    ran_plain = len(calls)
    cached = pipe(["a", "b"], block_cache_threshold=run["threshold"],
                  **dict(kw, num_inference_steps=run["cached_steps"]))
    return dict(plain=plain, cached=cached, span_calls=len(calls) - ran_plain)


def run_seq_traps(run):
    """(the gradient of a rank's shard through the output gather, with every
    rank's loss the same; the ring shift of the rank index and its
    gradient; the K/V gather and its gradient, with the ranks' losses
    weighed by rank + 1; `mean_abs_ratio` over ranks holding different
    rows)."""
    from pixart_sigma_tpu_torch.parallel import dist as pdist

    seq = _seq_world()
    r, n = seq.rank, seq.size
    x = torch.full((1, 2, 3), float(r)).requires_grad_(True)
    whole = seq.gather(x, 2 * n)
    (whole * torch.arange(1.0, 2 * n + 1)[None, :, None]).sum().backward()
    y = torch.tensor([float(r)]).requires_grad_(True)
    shifted = pdist.ring_shift(y)
    (shifted * (r + 1)).sum().backward()
    a = torch.tensor([[1.0 + r, -2.0 * r]])
    b = torch.tensor([[3.0, 1.0 + r]])
    # the K/V gather: its backward sums the ranks' partial gradients
    kv = torch.full((1, 2, 3), float(r)).requires_grad_(True)
    whole_kv = seq.gather_kv(kv, 2 * n)
    (whole_kv * torch.arange(1.0, 2 * n + 1)[None, :, None] * (r + 1)).sum().backward()
    return dict(gather_grad=x.grad, shifted=shifted.detach(), shift_grad=y.grad,
                kv=whole_kv.detach(), kv_grad=kv.grad,
                ratio=pdist.mean_abs_ratio(a, b, torch.distributed.group.WORLD),
                transports=dict(pdist.TRANSPORTS))


def spawn(tmp, world, runs, timeout=300):
    """Run `runs` on `world` ranks, each a worker process of this file
    (one process without a process group when world is 1); returns each
    rank's results."""
    import subprocess

    tmp = str(tmp)
    spec = dict(world=world, store=os.path.join(tmp, "store"),
                out=os.path.join(tmp, "out_{rank}.pt"), runs=runs)
    path = os.path.join(tmp, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ)
    env.pop("MASTER_ADDR", None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), path, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"
    return [torch.load(spec["out"].format(rank=r), weights_only=False) for r in range(world)]


def key_bias_free(name, t, hidden):
    """`t` without the entries of the keys' bias in self- and cross-
    attention: softmax is invariant to a per-query shift of its logits, so
    their gradient is zero and what is computed is rounding noise, which
    CAME's normalised update turns into +-lr whatever its size. Those
    entries are held finite only."""
    assert torch.isfinite(t).all(), name
    if name.endswith("attn.qkv.bias"):
        return torch.cat([t[:hidden], t[2 * hidden:]])
    if name.endswith("cross_attn.kv_linear.bias"):
        return t[hidden:]
    return t


def assert_same(got, want, hidden, rtol=2e-5, atol=2e-6):
    """Two {name: tensor} of one model, entry by entry."""
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(key_bias_free(n, got[n], hidden).numpy(),
                                   key_bias_free(n, want[n].detach().cpu(), hidden).numpy(),
                                   rtol=rtol, atol=atol, err_msg=n)


class StubPipe:
    """A pipeline whose call sums the ranks' index + 1 (a collective, so a
    rank that is gone fails it) into each prompt's 2 x 2 x 4 "latents"; on
    the prompt "die" rank 1 exits with 3 first. It refuses (`check_call`)
    the prompt "refuse"."""

    device = torch.device("cpu")
    vae = None
    base_resolution = 16
    SAMPLERS = ("dpm-solver",)

    class model:  # noqa: N801 - stands for the model's config
        cfg = type("cfg", (), {"multi_scale": True})

    def check_call(self, prompts, **kwargs):
        if "refuse" in prompts:
            raise ValueError("refused")

    def __call__(self, prompts, **kwargs):
        self.check_call(prompts)
        if "die" in prompts and torch.distributed.get_rank() == 1:
            os._exit(3)
        total = torch.tensor([torch.distributed.get_rank() + 1.0])
        torch.distributed.all_reduce(total)
        return np.full((len(prompts), 2, 2, 4), float(total), np.float32)


def serve_stub(store, rank):
    """`scripts.serve.serve` of a `StubPipe` on 2 gloo ranks; rank 0 prints
    where it serves. Returns the exit code."""
    from types import SimpleNamespace

    from pixart_sigma_tpu_torch.parallel.dist import initialize_distributed
    from pixart_sigma_tpu_torch.scripts import serve

    initialize_distributed(f"file://{store}", 2, rank, device="cpu", timeout=60)
    args = SimpleNamespace(max_wait_ms=10, max_batch=4, queue_depth=8, warmup=False,
                           host="127.0.0.1", port=0)
    return serve.serve(StubPipe(), args)


def main(spec_path, rank):
    spec = json.load(open(spec_path))
    torch.set_num_threads(1)
    if spec["world"] > 1:
        from pixart_sigma_tpu_torch.parallel.dist import initialize_distributed

        initialize_distributed(f"file://{spec['store']}", spec["world"], rank, device="cpu")
    kinds = dict(trainer=run_trainer, step=run_step, collectives=run_collectives,
                 seq_ops=run_seq_ops, seq_forward=run_seq_forward, seq_pipeline=run_seq_pipeline,
                 seq_traps=run_seq_traps)
    results = [kinds[run["kind"]](run) for run in spec["runs"]]
    torch.save(results, spec["out"].format(rank=rank))
    if spec["world"] > 1:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "--serve":
        sys.exit(serve_stub(sys.argv[2], int(sys.argv[3])))
    main(sys.argv[1], int(sys.argv[2]))
