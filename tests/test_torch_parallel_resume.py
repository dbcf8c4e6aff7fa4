"""Checkpoints across world sizes: the `.pth` holds whole tensors, so a run
saved on 2 FSDP ranks (fsdp = 2, `fsdp_min_size` 4096), or on 2 tensor-
parallel ranks, at step 2 resumes in one process and gives the 2-rank
run's step 3, and a one-process run's step-2 checkpoint resumes on 2 FSDP
ranks and gives its step 3: loss, parameters and EMA (rtol 2e-5, atol
2e-6), with the optimizer state, the generator and the LR schedule's
position restored. The same across tensor 2 x seq 2 on 4 ranks and one
process, both ways, and from a JAX trainer's orbax `step_N` (written from
a state sharded over the same mesh on JAX's virtual CPU devices), resumed
on tensor 2 x seq 2 and in one process. And the training CLI under
torchrun, on 2 ranks with FSDP and on 4 with tensor 2 x seq 2.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import os

import numpy as np
import pytest
import torch

from tests.torch_parallel_worker import TINY, assert_same, run_trainer, spawn, write_data

FSDP2 = dict(mesh=dict(data=1, fsdp=2), use_fsdp=True, fsdp_min_size=4096, train_batch_size=2)
TP2 = dict(mesh=dict(data=1, tensor=2), use_tensor_parallel=True, train_batch_size=4)
TP2_SEQ2 = dict(TP2, mesh=dict(data=1, tensor=2, seq=2))
ONE = dict(train_batch_size=4)


def _ckpt(work):
    return os.path.join(work, "checkpoints", "epoch_0_step_2.pth")


def _resume(root, work, ckpt, config):
    return dict(kind="trainer", data_root=root, work_dir=work, steps=1,
                config=dict(config, resume_from=dict(checkpoint=ckpt)))


def _same(got, want):
    assert [h["step"] for h in got["history"]] == [3]
    for k in ("loss", "mse", "grad_norm"):
        assert got["history"][0][k] == pytest.approx(want["history"][-1][k], rel=2e-5), k
    assert_same(got["params"], want["params"], TINY["hidden_size"])
    assert_same(got["ema"], want["ema"], TINY["hidden_size"])


def test_checkpoints_resume_across_world_sizes(tmp_path):
    root = write_data(tmp_path)
    one_work, two_work = str(tmp_path / "one"), str(tmp_path / "two")
    tp_work = str(tmp_path / "tp")
    one = run_trainer(dict(kind="trainer", data_root=root, work_dir=one_work, steps=3,
                           config=dict(ONE, save_model_steps=2)))
    ranks = spawn(tmp_path, 2, [
        dict(kind="trainer", data_root=root, work_dir=two_work, steps=3,
             config=dict(FSDP2, save_model_steps=2)),
        _resume(root, str(tmp_path / "two_from_one"), _ckpt(one_work), FSDP2),
        dict(kind="trainer", data_root=root, work_dir=tp_work, steps=3,
             config=dict(TP2, save_model_steps=2))])
    two, two_from_one, tp = ranks[0]
    # the 2-rank runs equal the one-process run, and each resumes the other
    assert_same(two["params"], one["params"], TINY["hidden_size"])
    assert_same(tp["params"], one["params"], TINY["hidden_size"])
    _same(two_from_one, one)
    _same(ranks[1][1], one)
    one_from_two = run_trainer(_resume(root, str(tmp_path / "one_from_two"), _ckpt(two_work),
                                       ONE))
    _same(one_from_two, two)
    # a tensor-parallel checkpoint (its CAME state gathered over the tensor axis)
    one_from_tp = run_trainer(_resume(root, str(tmp_path / "one_from_tp"), _ckpt(tp_work), ONE))
    _same(one_from_tp, tp)


def _same_optimizer(got, want):
    """The LR schedule's position and the optimizer state, each tensor
    within 2e-5 relative L2 (its moments follow gradients that differ by
    float rounding, which CAME's normalised update magnifies in a few
    elements, 3e-4 relative at most). The statistics of the keys' bias, whose
    gradient is rounding noise (`key_bias_free`), are held finite only:
    those of self- and cross-attention's fused biases (a stacked bias's row
    statistics mix its entries)."""
    assert got["opt_step"] == want["opt_step"]
    a, b = got["optimizer"], want["optimizer"]
    assert a["param_groups"] == b["param_groups"]
    assert a["state"].keys() == b["state"].keys()
    names = got["optimizer_names"]
    assert names == want["optimizer_names"]
    for i, st in b["state"].items():
        noisy = names[i].endswith(("attn.qkv.bias", "cross_attn.kv_linear.bias"))
        assert st.keys() == a["state"][i].keys()
        for k, v in st.items():
            if not torch.is_tensor(v):
                assert a["state"][i][k] == v, (names[i], k)
            elif noisy:
                assert torch.isfinite(a["state"][i][k]).all(), (names[i], k)
            else:
                x, y = a["state"][i][k].double(), v.double()
                assert (x - y).norm() <= 2e-5 * y.norm(), (names[i], k)


def _jax_orbax_step(work, root):
    """A JAX trainer's `checkpoints/step_2` under `work`: the tiny model's
    TrainState (CAME behind the config's clip, the EMA) after two steps of
    seeded gradients, sharded as `make_train_step` shards it over tensor 2 x
    seq 2 on 4 of JAX's virtual CPU devices, saved by `save_train_state`."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from pixart_sigma_tpu.models.pixart import PixArt as JaxPixArt
    from pixart_sigma_tpu.models.pixart import PixArtConfig as JaxConfig
    from pixart_sigma_tpu.parallel.mesh import MeshConfig, build_mesh, param_sharding
    from pixart_sigma_tpu.training import TrainState as JaxTrainState
    from pixart_sigma_tpu.training import build_lr_schedule as jax_lr_schedule
    from pixart_sigma_tpu.training import build_optimizer as jax_build_optimizer
    from pixart_sigma_tpu.utils import checkpoint as jckpt
    from pixart_sigma_tpu_torch.models.builder import build_model_from_config
    from tests.torch_parallel_worker import tiny_config

    cfg = tiny_config(root)
    pcfg = build_model_from_config(cfg, device="meta", train=True).cfg
    kw = {f.name: getattr(pcfg, f.name) for f in dataclasses.fields(JaxConfig)
          if f.name != "dtype"}
    jm = JaxPixArt(JaxConfig(**kw, dtype=jnp.float32))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                              jnp.zeros((1, 8, pcfg.caption_channels)),
                              jnp.ones((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(4)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape), jnp.float32), params)
    grads = [jax.tree_util.tree_map(lambda a: jnp.asarray(rng.randn(*a.shape), jnp.float32),
                                    params) for _ in range(2)]
    opt = dict(cfg.optimizer)
    # the saved steps at a small rate: the weights stay near their init, where
    # the loss is of order 1 (the schedule is not saved, only its position)
    opt.pop("lr")
    schedule = jax_lr_schedule(cfg.lr_schedule, 1e-4, num_training_steps=100,
                               **cfg.lr_schedule_args)
    tx = jax_build_optimizer(name=opt.pop("type"), learning_rate=schedule,
                             grad_clip_norm=cfg.gradient_clip, **opt)
    mesh = build_mesh(MeshConfig(data=1, tensor=2, seq=2), devices=jax.devices()[:4])
    place = lambda tree: jax.device_put(tree, param_sharding(tree, mesh, tensor=True))
    state = JaxTrainState.create(params=params, tx=tx, ema=True, ema_rate=cfg.ema_rate)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    for g in grads:
        state = apply(state, g)
    state = state.replace(params=place(state.params), opt_state=place(state.opt_state),
                          ema_params=place(state.ema_params))
    assert len(state.params["final_layer"]["linear"]["kernel"].sharding.device_set) == 4
    return jckpt.save_train_state(os.path.join(work, "checkpoints"), state)


def test_checkpoints_cross_between_seq_with_tensor_and_one_process(tmp_path):
    """tensor 2 x seq 2 on 4 ranks: its step-2 `.pth` resumes in one process
    and gives its step 3; one process's step-2 `.pth` resumes on it and
    gives one process's step 3; a JAX orbax `step_2` resumes on it and in
    one process alike. Loss, parameters, EMA, the optimizer state and the
    LR position."""
    root = write_data(tmp_path)
    one_work, ts_work = str(tmp_path / "one"), str(tmp_path / "ts")
    orbax_step = _jax_orbax_step(str(tmp_path / "jax"), root)
    one = run_trainer(dict(kind="trainer", data_root=root, work_dir=one_work, steps=3,
                           config=dict(ONE, save_model_steps=2)))
    ranks = spawn(tmp_path, 4, [
        dict(kind="trainer", data_root=root, work_dir=ts_work, steps=3,
             config=dict(TP2_SEQ2, save_model_steps=2)),
        _resume(root, str(tmp_path / "ts_from_one"), _ckpt(one_work), TP2_SEQ2),
        _resume(root, str(tmp_path / "ts_from_orbax"), orbax_step, TP2_SEQ2)])
    ts, ts_from_one, ts_from_orbax = ranks[0]
    assert_same(ts["params"], one["params"], TINY["hidden_size"])
    for r in ranks:
        _same(r[1], one)
        _same_optimizer(r[1], one)
    one_from_ts = run_trainer(_resume(root, str(tmp_path / "one_from_ts"), _ckpt(ts_work), ONE))
    _same(one_from_ts, ts)
    _same_optimizer(one_from_ts, ts)
    one_from_orbax = run_trainer(_resume(root, str(tmp_path / "one_from_orbax"), orbax_step,
                                         ONE))
    assert [h["step"] for h in one_from_orbax["history"]] == [3]
    assert one_from_orbax["opt_step"] == 3
    for r in ranks:
        got = dict(r[2], history=[dict(h) for h in r[2]["history"]])
        _same(got, one_from_orbax)
        _same_optimizer(got, one_from_orbax)


def _torchrun(tmp_path, root, nproc, parallel):
    """`torchrun --nproc-per-node N -m pixart_sigma_tpu_torch.scripts.train
    CONFIG --device cpu` for 2 steps on a tiny config with the keys of
    `parallel`, saving at step 2; returns its work dir."""
    import subprocess
    import sys

    from tests.torch_parallel_worker import ROOT, SIGMA_1024, tiny_config

    keys = dict(image_size=256, aspect_ratio_type=256, num_workers=1,
                log_interval=1, mixed_precision="fp32", seed=3,
                lr_schedule_args=dict(num_warmup_steps=0), save_model_steps=2,
                save_model_epochs=10**6, model_overrides=dict(TINY), data=dict(root="data"),
                optimizer=dict(tiny_config(root).optimizer), **parallel)
    config = tmp_path / "tiny_parallel.py"
    config.write_text(f"_base_ = [{SIGMA_1024!r}]\n"
                      + "".join(f"{k} = {v!r}\n" for k, v in keys.items()))
    work = tmp_path / "cli"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(nproc), "-m", "pixart_sigma_tpu_torch.scripts.train", str(config), "--work-dir",
         str(work), "--data-root", root, "--features", "--device", "cpu", "--max-steps", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT")})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    with open(work / "metrics.jsonl") as f:
        assert [__import__("json").loads(line)["step"] for line in f] == [1, 2]
    return work


def _cli_equals_one_process(tmp_path, nproc, parallel):
    import torch

    root = write_data(tmp_path)
    work = _torchrun(tmp_path, root, nproc, parallel)
    one = run_trainer(dict(kind="trainer", data_root=root, work_dir=str(tmp_path / "one"),
                           steps=2, config=ONE))
    ckpt = torch.load(work / "checkpoints" / "epoch_0_step_2.pth", weights_only=True)
    assert_same(ckpt["state_dict"], one["params"], TINY["hidden_size"])
    assert_same(ckpt["state_dict_ema"], one["ema"], TINY["hidden_size"])


def test_torchrun_cli_on_two_gloo_ranks(tmp_path):
    """`torchrun --nproc-per-node 2 -m pixart_sigma_tpu_torch.scripts.train
    CONFIG --device cpu`: FSDP over 2 gloo ranks from torchrun's
    environment; rank 0 writes metrics.jsonl (each step once) and the
    step-2 `.pth`, whose weights and EMA are one process's at the global
    batch."""
    _cli_equals_one_process(tmp_path, 2, FSDP2)


def test_torchrun_cli_on_four_gloo_ranks_over_seq_and_tensor(tmp_path):
    """The same with tensor 2 x seq 2 over 4 gloo ranks."""
    _cli_equals_one_process(tmp_path, 4, TP2_SEQ2)
