"""One rank of a multi-rank run of the port over gloo, for the tests of
tests/test_torch_parallel_*.py. It imports torch and the port only.

    python tests/torch_parallel_worker.py SPEC.json RANK

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

Each run records, gathered whole: the parameters, the EMA and the per-step
metrics, and this rank's bytes of parameters, optimizer state and EMA
against their replicated total.
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


def _bytes(state):
    """(this rank's bytes of parameters, optimizer state and EMA; their
    replicated total)."""
    from pixart_sigma_tpu_torch.parallel.sharded import local

    params = list(state.model.parameters())
    mine = sum(local(p).nelement() * local(p).element_size() for p in params)
    total = sum(p.nelement() * p.element_size() for p in params)
    mine += sum(e.nelement() * e.element_size() for e in state.ema.values())
    total += sum(p.nelement() * p.element_size() for p in params)
    for st in state.optimizer.state.values():
        mine += sum(v.nelement() * v.element_size() for v in st.values()
                    if torch.is_tensor(v) and v.ndim)
    for st in state.optimizer.full_state_dict()["state"].values():
        total += sum(v.nelement() * v.element_size() for v in st.values()
                     if torch.is_tensor(v) and v.ndim)
    return mine, total


def _whole(state):
    from pixart_sigma_tpu_torch.parallel.sharded import full_state, local

    named = dict(state.model.named_parameters())
    params = full_state(((n, local(p)) for n, p in named.items()), named)
    return params, state.full_ema()


def run_trainer(run):
    from pixart_sigma_tpu_torch.training.trainer import Trainer

    cfg = tiny_config(run["data_root"], **run.get("config", {}))
    with one_thread():
        trainer = Trainer(cfg, run["work_dir"], device="cpu")
        trainer.train(max_steps=run["steps"])
    params, ema = _whole(trainer.state)
    mine, total = _bytes(trainer.state)
    sampler = trainer.schedule_sampler
    return dict(params=params, ema=ema, history=[
        {k: v for k, v in h.items() if k != "seconds"} for h in trainer.history],
        bytes=mine, total_bytes=total, batch_rank=trainer.batch_rank,
        sampler=None if sampler is None else sampler.state_dict())


def run_step(run):
    from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
    from pixart_sigma_tpu_torch.models.builder import build_model_from_config
    from pixart_sigma_tpu_torch.parallel import mesh as mesh_lib
    from pixart_sigma_tpu_torch.training.optim import block_stacks, build_optimizer
    from pixart_sigma_tpu_torch.training.train_state import TrainState
    from pixart_sigma_tpu_torch.training.train_step import train_step

    cfg = tiny_config("", **run.get("config", {}))
    model = build_model_from_config(cfg, device="cpu", train=True)
    weights = {k: torch.from_numpy(v) for k, v in np.load(run["weights"]).items()}
    model.load_state_dict(weights)
    data = {k: torch.from_numpy(v) for k, v in np.load(run["batch"]).items()}
    forward, sync, group, ranks, rank = model, (), None, 1, 0
    if torch.distributed.is_initialized():
        mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(**cfg.mesh), "cpu")
        group = mesh_lib.batch_group(mesh)
        forward, sync = mesh_lib.shard_model(model, mesh, fsdp=cfg.get("use_fsdp", False),
                                             tensor=cfg.get("use_tensor_parallel", False),
                                             min_size=cfg.get("fsdp_min_size", 2**16),
                                             batch_group=group)
        ranks, rank = mesh_lib.batch_ranks(mesh), mesh_lib.batch_rank(mesh)
    named = list(model.named_parameters())
    stacks = block_stacks([n for n, _ in named], model.cfg.block_groups())
    optimizer = build_optimizer(named, name="came", lr=0.0, stacks=stacks)
    state = TrainState(model, optimizer, lambda step: run["lr"], ema=True,
                       ema_rate=run["ema_rate"])
    state.forward, state.sync_params = forward, [p for p in model.parameters() if p in sync]
    state.batch_group, state.batch_ranks, state.batch_rank = group, ranks, rank
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


def main(spec_path, rank):
    spec = json.load(open(spec_path))
    torch.set_num_threads(1)
    if spec["world"] > 1:
        from pixart_sigma_tpu_torch.parallel.dist import initialize_distributed

        initialize_distributed(f"file://{spec['store']}", spec["world"], rank, device="cpu")
    kinds = dict(trainer=run_trainer, step=run_step, collectives=run_collectives)
    results = [kinds[run["kind"]](run) for run in spec["runs"]]
    torch.save(results, spec["out"].format(rank=rank))
    if spec["world"] > 1:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
