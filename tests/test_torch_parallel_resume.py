"""Checkpoints across world sizes: the `.pth` holds whole tensors, so a run
saved on 2 FSDP ranks (fsdp = 2, `fsdp_min_size` 4096), or on 2 tensor-
parallel ranks, at step 2 resumes in one process and gives the 2-rank
run's step 3, and a one-process run's step-2 checkpoint resumes on 2 FSDP
ranks and gives its step 3: loss, parameters and EMA (rtol 2e-5, atol
2e-6), with the optimizer state, the generator and the LR schedule's
position restored. And the training CLI under torchrun.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import os

import pytest

from tests.torch_parallel_worker import TINY, assert_same, run_trainer, spawn, write_data

FSDP2 = dict(mesh=dict(data=1, fsdp=2), use_fsdp=True, fsdp_min_size=4096, train_batch_size=2)
TP2 = dict(mesh=dict(data=1, tensor=2), use_tensor_parallel=True, train_batch_size=4)
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


def test_torchrun_cli_on_two_gloo_ranks(tmp_path):
    """`torchrun --nproc-per-node 2 -m pixart_sigma_tpu_torch.scripts.train
    CONFIG --device cpu`: FSDP over 2 gloo ranks from torchrun's
    environment; rank 0 writes metrics.jsonl (each step once) and the
    step-2 `.pth`, whose weights and EMA are one process's at the global
    batch."""
    import subprocess
    import sys

    import torch

    from tests.torch_parallel_worker import ROOT, SIGMA_1024, tiny_config

    root = write_data(tmp_path)
    keys = dict(image_size=256, aspect_ratio_type=256, num_workers=1,
                log_interval=1, mixed_precision="fp32", seed=3,
                lr_schedule_args=dict(num_warmup_steps=0), save_model_steps=2,
                save_model_epochs=10**6, model_overrides=dict(TINY), data=dict(root="data"),
                optimizer=dict(tiny_config(root).optimizer), **FSDP2)
    config = tmp_path / "tiny_fsdp.py"
    config.write_text(f"_base_ = [{SIGMA_1024!r}]\n"
                      + "".join(f"{k} = {v!r}\n" for k, v in keys.items()))
    work = tmp_path / "cli"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "pixart_sigma_tpu_torch.scripts.train", str(config), "--work-dir", str(work),
         "--data-root", root, "--features", "--device", "cpu", "--max-steps", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT")})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    with open(work / "metrics.jsonl") as f:
        assert [__import__("json").loads(line)["step"] for line in f] == [1, 2]
    one = run_trainer(dict(kind="trainer", data_root=root, work_dir=str(tmp_path / "one"),
                           steps=2, config=ONE))
    ckpt = torch.load(work / "checkpoints" / "epoch_0_step_2.pth", weights_only=True)
    assert_same(ckpt["state_dict"], one["params"], TINY["hidden_size"])
    assert_same(ckpt["state_dict_ema"], one["ema"], TINY["hidden_size"])
