"""The port's Trainer on 2 gloo ranks against one process at the global
batch: data parallel (DDP), FSDP (fsdp = 2, `fsdp_min_size` 4096) and
tensor parallel (tensor = 2), 3 steps of the 1024px KV-compress config cut
to a tiny f32 model at 256px, with validation sampling at step 3; and data
parallelism with the loss-second-moment resampler, gradient accumulation
and token masking (every rank draws the global token mask and caption
drops; the resampler learns from the all-gathered losses). The loss
trajectory, the final parameters and EMA (rtol 2e-5, atol 2e-6, the
tolerance of the JAX package's FSDP-vs-DP test), the resampler's ring (bit
for bit) and the validation latents (1e-5 relative L2) must match;
metrics.jsonl holds each step once; FSDP's per-rank bytes of parameters,
optimizer state and EMA are under 0.6 of the replicated total
(tests/test_fsdp.py). HSDP is in tests/test_torch_parallel_hsdp.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.torch_parallel_worker import TINY, assert_same, run_trainer, spawn, write_data

VALIDATE = dict(visualize=True, eval_sampling_steps=3)
# the draws the step makes for the model (token mask, caption drops), the
# resampler's global update and accumulation, without KV compression (which
# masking excludes)
FEATURES = dict(schedule_sampler="loss-second-moment", gradient_accumulation_steps=2,
                mask_loss_coef=1.0, model_overrides=dict(kv_compress_layers=(), mask_ratio=0.25))
CASES = {
    "dp2": dict(mesh=dict(data=2), train_batch_size=2),
    "dp2_features": dict(mesh=dict(data=2), train_batch_size=2, **FEATURES),
    "fsdp2": dict(mesh=dict(data=1, fsdp=2), use_fsdp=True, fsdp_min_size=4096,
                  train_batch_size=2),
    "tensor2": dict(mesh=dict(data=1, tensor=2), use_tensor_parallel=True, train_batch_size=4),
}


def _reference(root, name, **config):
    work = os.path.join(root, name)
    out = run_trainer(dict(kind="trainer", data_root=root, work_dir=work, steps=3,
                           config=dict(VALIDATE, train_batch_size=4, **config)))
    return root, out, np.load(os.path.join(work, "validation_step_3.npy"))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(data root, one process's run at the global batch of 4, its
    validation latents)."""
    return _reference(write_data(tmp_path_factory.mktemp("parallel_train")), "one")


def check_against_reference(got, reference, work):
    """Every rank's history, parameters, EMA and resampler ring against the
    one-process run; metrics.jsonl and the validation latents rank 0
    wrote."""
    _, want, want_val = reference
    for r in got:
        if want["sampler"] is not None:
            for k, v in want["sampler"].items():
                assert torch.equal(r["sampler"][k], v), k
        assert [h["step"] for h in r["history"]] == [1, 2, 3]
        for a, b in zip(r["history"], want["history"]):
            for k in ("loss", "mse", "vb", "grad_norm"):
                assert a[k] == pytest.approx(b[k], rel=2e-5), (k, a, b)
        assert_same(r["params"], want["params"], TINY["hidden_size"])
        assert_same(r["ema"], want["ema"], TINY["hidden_size"])
    with open(os.path.join(work, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3]
    # 14 solver steps with CFG 4.5 on an untrained model grow the latents to
    # ~1e3: held by their relative L2 distance
    got_val = np.load(os.path.join(work, "validation_step_3.npy")).astype(np.float64)
    assert np.linalg.norm(got_val - want_val) <= 1e-5 * np.linalg.norm(want_val)


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """The three cases one after another in one pair of gloo processes:
    {case: (each rank's results, its work dir)}."""
    tmp = tmp_path_factory.mktemp("train_ranks")
    root = reference[0]
    runs = [dict(kind="trainer", data_root=root, work_dir=str(tmp / case), steps=3,
                 config=dict(CASES[case], **VALIDATE)) for case in sorted(CASES)]
    got = spawn(tmp, 2, runs)
    return {case: ([r[i] for r in got], str(tmp / case)) for i, case in enumerate(sorted(CASES))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_match_one_process_at_the_global_batch(case, reference, ranks):
    got, work = ranks[case]
    if case == "dp2_features":
        reference = _reference(reference[0], "one_features", **FEATURES)
    check_against_reference(got, reference, work)
    if case == "tensor2":
        assert [r["batch_rank"] for r in got] == [0, 0]  # both ranks see all rows
    else:
        assert [r["batch_rank"] for r in got] == [0, 1]
    ratio = got[0]["bytes"] / got[0]["total_bytes"]
    if case.startswith("dp2"):
        assert ratio == 1.0
    elif case == "fsdp2":
        assert ratio < 0.6, ratio
    else:
        assert ratio < 0.8, ratio


def test_the_steps_draws_are_those_the_model_makes_itself_on_one_rank():
    """`train_step` hands the model its token-mask noise and caption drops
    at every world size; on one rank they are the draws the model would make
    itself from the same generator, so a masked model's loss is the same bit
    for bit."""
    from types import SimpleNamespace

    from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
    from pixart_sigma_tpu_torch.models.builder import build_model_from_config
    from pixart_sigma_tpu_torch.training.train_step import _draws, compute_losses
    from tests.torch_parallel_worker import tiny_config

    cfg = tiny_config("", class_dropout_prob=0.5, **FEATURES)
    torch.manual_seed(0)
    model = build_model_from_config(cfg, device="cpu", train=True)
    diffusion = IDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)
    rng = np.random.default_rng(0)
    batch = dict(latents=torch.from_numpy(rng.standard_normal((4, 32, 32, 4), np.float32)),
                 y=torch.from_numpy(rng.standard_normal((4, 300, 64), np.float32)),
                 y_mask=torch.ones((4, 300), dtype=torch.int32))
    state = SimpleNamespace(model=model, batch_ranks=1, batch_rank=0)
    gen = torch.Generator().manual_seed(2)
    _, d = _draws(state, diffusion, batch["latents"], gen, None, None, None, None)
    assert d["mask_noise"].shape == (4, 16 * 16)
    assert set(d["force_drop_ids"].tolist()) == {0, 1}  # some captions dropped, some kept
    with torch.no_grad():
        given = compute_losses(model, diffusion, batch, d["t"], d["noise"],
                               force_drop_ids=d["force_drop_ids"], mask_noise=d["mask_noise"],
                               mask_loss_coef=1.0)
        gen = torch.Generator().manual_seed(2)
        t = torch.randint(0, diffusion.num_timesteps, (4,), generator=gen)
        noise = torch.randn(batch["latents"].shape, generator=gen)
        own = compute_losses(model, diffusion, batch, t, noise, generator=gen,
                             mask_loss_coef=1.0)
    assert torch.equal(given["per_sample"], own["per_sample"])
