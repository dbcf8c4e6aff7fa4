"""Sequence (context) parallelism of the port against the JAX package,
whose seq-axis paths run on its 8 virtual CPU devices (tests/conftest.py),
and the port's over gloo worker processes (tests/torch_parallel_worker.py:
one spawn of 2 ranks and one of 4, each a list of runs). f32, with JAX's own
tolerances (tests/test_seq_parallel.py): 2e-5 forward, 2e-4 gradients.

- `chunked_attention` (single device) against JAX's, forward and
  gradients; `seq_dispatch` against JAX's `_dispatch` under seq meshes
  (caption keys, non-dividing tokens, the `RING_KV_BYTES` switch).
- seqshard and ring attention, masked or not, on 2 and 4 ranks against
  JAX's under a seq mesh of the same size: outputs and dq, dk, dv.
- A tiny model's token-sharded forward against JAX's single-device one:
  square, KV-compressed (compressed on the shard, and gathered first when
  the shards' rows do not divide by the ratio), rectangular multi-scale,
  and tokens that do not divide the ranks (padded, the chunked route).
- The pipeline over data 2 x seq 2 against JAX's pipeline on the same
  latents, and with the adaptive block cache against one process: every
  rank must take the refresh decisions one process takes.
- The Trainer over seq 2 (also with token masking, the resampler and
  accumulation), over data 2 x seq 2 and over fsdp 2 x seq 2 (FSDP2's
  reduce-scatters in the backward beside the seq group's) against one
  process at the global batch (tests/test_torch_parallel_train.py's
  checks). With tensor parallelism: tensor 2 x seq 2, also with token
  masking and accumulation, and with a KV-compressed layer whose shards'
  rows do not divide by the ratio (compressed after the gather); tensor 2
  alone beside it, whose per-rank bytes tensor 2 x seq 2 must equal, and
  whose tensor layers move their activations through `parallel.dist` (its
  count of all-gathers).
- The three traps: the output gather's gradient is each rank's slice, not
  seq-size times it; the parameters' gradients are summed over seq (the
  Trainer's gradient norm equals one process's); the cache drift is
  reduced over the ranks (`mean_abs_ratio` on ranks holding other rows).
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.models.pixart import PixArt as JaxPixArt
from pixart_sigma_tpu.models.pixart import PixArtConfig as JaxConfig
from pixart_sigma_tpu.parallel.mesh import MeshConfig, build_mesh
from pixart_sigma_tpu_torch.ops import attention as tattn
from pixart_sigma_tpu_torch.utils.checkpoint import state_dict_from_jax
from tests.test_torch_parallel_train import FEATURES, VALIDATE, _reference, check_against_reference
from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset
from pixart_sigma_tpu_torch.models.layers import SelfAttentionKVCompress
from pixart_sigma_tpu_torch.parallel.mesh import SeqContext
from tests.torch_parallel_worker import TINY as TINY_TRAIN
from tests.torch_parallel_worker import spawn, tiny_seq_model, write_data

jattn = importlib.import_module("pixart_sigma_tpu.ops.attention")
FWD, GRAD = 2e-5, 2e-4
TINY = dict(depth=2, hidden_size=48, num_heads=4, caption_channels=32, model_max_length=8,
            in_channels=4)
CONV = dict(kv_compress_sampling="conv", kv_compress_scale=2)
# (name, config, latent H x W, worlds): the rank count each runs on
FORWARDS = (
    ("square", dict(multi_scale=False), (16, 16), (2,)),
    ("conv_local", dict(CONV, kv_compress_layers=(0, 1), qk_norm=True), (16, 16), (2, 4)),
    ("rect", dict(multi_scale=True), (8, 24), (4,)),
    ("conv_gather_first", dict(CONV, kv_compress_layers=(1,)), (12, 16), (4,)),
    ("padded", dict(CONV, kv_compress_layers=(1,)), (10, 14), (4,)),
)
TENSOR2 = dict(mesh=dict(data=1, tensor=2), use_tensor_parallel=True, train_batch_size=4)
TENSOR2_SEQ2 = dict(TENSOR2, mesh=dict(data=1, tensor=2, seq=2))
# the 256px bucket 192 x 320: a 12 x 20 token grid, 6 rows a seq rank, which
# KV compression by 4 does not divide (12 does): compressed after the gather
WIDE, GATHER_FIRST = (192, 320), dict(model_overrides=dict(kv_compress_scale=4))
TRAINER_CASES = {
    2: {"seq2": dict(mesh=dict(data=1, seq=2), train_batch_size=4),
        "seq2_features": dict(mesh=dict(data=1, seq=2), train_batch_size=4, **FEATURES),
        "tensor2": TENSOR2},
    4: {"data2_seq2": dict(mesh=dict(data=2, seq=2), train_batch_size=2),
        "fsdp2_seq2": dict(mesh=dict(data=1, fsdp=2, seq=2), use_fsdp=True, fsdp_min_size=4096,
                           train_batch_size=2),
        "tensor2_seq2": TENSOR2_SEQ2,
        "tensor2_seq2_features": dict(TENSOR2_SEQ2, **FEATURES),
        "tensor2_seq2_gather_first": dict(TENSOR2_SEQ2, **GATHER_FIRST)},
}
BATCH_RANKS = {"data2_seq2": [0, 0, 1, 1], "fsdp2_seq2": [0, 0, 1, 1]}  # else all 0
PIPE_CONFIG = dict(TINY, cache_span=(1, 2))
THRESHOLD, CACHED_STEPS = 3.0, 8  # the tiny model's drift then refreshes 4 of 8 calls


def _np(a):
    return np.asarray(a, np.float64)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,N,M,H,Dh,chunk,masked", [
    (2, 64, 64, 4, 16, 16, False),
    (2, 64, 50, 4, 16, 16, True),
    (1, 32, 300, 2, 72, 128, True),
    (2, 48, 8, 2, 16, 64, False),
])
def test_chunked_matches_jax(B, N, M, H, Dh, chunk, masked):
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(B, n, H, Dh).astype(np.float32) for n in (N, M, M))
    mask = None
    if masked:
        mask = rng.rand(B, M) > 0.3
        mask[:, 0] = True
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   key_mask=None if mask is None else jnp.asarray(mask),
                                   chunk=chunk)
    got = tattn.chunked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  key_mask=None if mask is None else torch.from_numpy(mask),
                                  chunk=chunk)
    _close(got, want, FWD)


def test_chunked_gradients_match_jax():
    rng = np.random.RandomState(1)
    q, k, v, cot = (rng.randn(2, n, 2, 16).astype(np.float32) for n in (32, 40, 40, 32))
    want = jax.grad(lambda q, k, v: (jattn.chunked_attention(q, k, v, chunk=16) * cot).sum(),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (tattn.chunked_attention(*ts, chunk=16) * torch.from_numpy(cot)).sum().backward()
    for t, w in zip(ts, want):
        _close(t.grad, w, 1e-4)  # JAX's tolerance for the same check


class _Shaped:  # shape-only stand-in, as JAX's test (a 262k-token array is 10 GB)
    def __init__(self, shape):
        self.shape = shape


def test_seq_dispatch_matches_jax(monkeypatch):
    """Under JAX's seq meshes (seq 8, and data 2 x seq 4 with the ring gate
    lowered) the port's rule picks what JAX's `_dispatch` picks, JAX's
    "xla" (keys within 512) being the port's "local"."""
    def both(shape_q, shape_k, masked, mesh_cfg, batch_div):
        with jax.set_mesh(build_mesh(mesh_cfg)):
            want = jattn._dispatch(_Shaped(shape_q), _Shaped(shape_k),
                                   jnp.ones((1, 1), bool) if masked else None)
        got = tattn.seq_dispatch(shape_q[1], shape_k[1], shape_q[0] // batch_div, shape_k[2],
                                 shape_k[3], mesh_cfg.seq)
        return {"xla": "local"}.get(want, want), got

    seq8 = MeshConfig(data=1, seq=8)
    for q, k, masked, pick in (
            ((1, 1024, 4, 72), (1, 1024, 4, 72), False, "seqshard"),
            ((1, 1020, 4, 72), (1, 1024, 4, 72), False, "chunked"),
            ((1, 1024, 4, 72), (1, 300, 4, 72), True, "local"),
            ((1, 65536, 16, 72), (1, 65536, 16, 72), False, "seqshard"),
            ((1, 262144, 16, 72), (1, 262144, 16, 72), False, "ring")):
        assert both(q, k, masked, seq8, 1) == (pick, pick), (q, k)
    monkeypatch.setattr(jattn, "RING_KV_BYTES", 1024)
    monkeypatch.setattr(tattn, "RING_KV_BYTES", 1024)
    assert both((8, 1024, 2, 16), (8, 1024, 2, 16), False, MeshConfig(data=-1, seq=4), 2) == (
        "ring", "ring")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The inputs and weights of every run, written for the workers, and
    JAX's answers: {"ops": {s: ...}, "forward": {name: ...}, "pipeline":
    latents}."""
    tmp = tmp_path_factory.mktemp("seq_files")
    out = {"tmp": tmp}
    rng = np.random.RandomState(31)
    B, N, H, Dh = 4, 64, 2, 16
    q, k, v, cot = (rng.randn(B, N, H, Dh).astype(np.float32) for _ in range(4))
    mask = rng.rand(B, N) > 0.3
    mask[:, 0] = True
    np.savez(tmp / "ops.npz", q=q, k=k, v=v, cot=cot, mask=mask)
    jq, jk, jv, jm = (jnp.asarray(a) for a in (q, k, v, mask))
    ops = {}
    for s in (2, 4):
        with jax.set_mesh(build_mesh(MeshConfig(data=-1, seq=s))):
            for name in ("seqshard", "ring"):
                for masked in (False, True):
                    km = jm if masked else None
                    fn = (lambda q, k, v: jattn.seq_sharded_attention(
                        q, k, v, key_mask=km, fp32_softmax=True)) if name == "seqshard" else (
                        lambda q, k, v: jattn.ring_attention(q, k, v, key_mask=km))
                    fwd, vjp = jax.vjp(jax.jit(fn), jq, jk, jv)
                    ops[s, name, masked] = [fwd, *vjp(jnp.asarray(cot))]
    out["ops"] = ops
    out["forward"] = {}
    for name, kw, (Hx, Wx), _ in FORWARDS:
        cfg = JaxConfig(**TINY, **kw, dtype=jnp.float32)
        model = JaxPixArt(cfg)
        r = np.random.RandomState(2)
        x = r.randn(2, Hx, Wx, 4).astype(np.float32)
        t = np.asarray([5.0, 700.0], np.float32)
        y = r.randn(2, 8, 32).astype(np.float32)
        ym = (r.rand(2, 8) > 0.2).astype(np.int32)
        params = jax.jit(model.init)(jax.random.PRNGKey(0), x, t, y, ym)["params"]
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a) + 0.05 * r.randn(*a.shape), jnp.float32), params)
        want = jax.jit(lambda p: model.apply({"params": p}, x, t, y, ym))(params)
        np.savez(tmp / f"w_{name}.npz", **{k: v.numpy() for k, v in
                                           state_dict_from_jax(params, cfg).items()})
        np.savez(tmp / f"x_{name}.npz", x=x, t=t, y=y, mask=ym)
        out["forward"][name] = np.asarray(want)
        if name == "square":  # the pipeline's weights too
            from pixart_sigma_tpu.pipelines import PixArtPipeline as JaxPipeline

            lat = r.randn(2, 8, 8, 4).astype(np.float32)
            yp, yn = (r.randn(2, 8, 32).astype(np.float32) for _ in range(2))
            ymask = np.ones((2, 8), np.int32)
            np.savez(tmp / "pipe.npz", latents=lat, y=yp, y_mask=ymask, y_null=yn)
            out["pipeline"] = np.asarray(JaxPipeline(model, {"params": params},
                                                     base_resolution=256)(
                ["a", "b"], height=64, width=64, num_inference_steps=4, sampler="dpm-solver",
                y=jnp.asarray(yp), y_mask=jnp.asarray(ymask), y_null=jnp.asarray(yn),
                latents=jnp.asarray(lat), return_latents=True))
    return out


def _root(roots, case):
    """The data root of a Trainer case: the wide bucket's for gather_first."""
    return roots[1] if case.endswith("gather_first") else roots[0]


def _runs(files, world, roots):
    tmp = files["tmp"]
    runs = [dict(kind="seq_traps"), dict(kind="seq_ops", inputs=str(tmp / "ops.npz"))]
    runs += [dict(kind="seq_forward", weights=str(tmp / f"w_{name}.npz"),
                  inputs=str(tmp / f"x_{name}.npz"), config=dict(TINY, **kw))
             for name, kw, _, worlds in FORWARDS if world in worlds]
    if world == 4:
        runs.append(dict(kind="seq_pipeline", weights=str(tmp / "w_square.npz"),
                         inputs=str(tmp / "pipe.npz"), mesh=dict(data=2, seq=2),
                         config=dict(PIPE_CONFIG, multi_scale=False), threshold=THRESHOLD,
                         cached_steps=CACHED_STEPS))
    runs += [dict(kind="trainer", data_root=_root(roots, case),
                  work_dir=str(tmp / f"train_{case}"), steps=3, config=dict(cfg, **VALIDATE))
             for case, cfg in sorted(TRAINER_CASES[world].items())]
    return runs


@pytest.fixture(scope="module")
def ranks(files, tmp_path_factory):
    """{world: each rank's results} of one spawn per world size, and the
    data roots of the Trainer runs: the square bucket's, and the wide
    one's."""
    root = write_data(tmp_path_factory.mktemp("seq_data"))
    wide = str(tmp_path_factory.mktemp("seq_wide"))
    write_feature_dataset(os.path.join(wide, "data"), [WIDE] * 12, resolution=256,
                          caption_channels=TINY_TRAIN["caption_channels"])
    roots = (root, wide)
    got = {w: spawn(tmp_path_factory.mktemp(f"seq_{w}"), w, _runs(files, w, roots))
           for w in (2, 4)}
    return got, roots


def _results(ranks, world, kind, files, name=None):
    """Every rank's result of the run `kind` (and forward `name`)."""
    runs = _runs(files, world, ranks[1])
    i = next(j for j, r in enumerate(runs) if r["kind"] == kind
             and (name is None or r.get("weights", "").endswith(f"w_{name}.npz")
                  or r.get("work_dir", "").endswith(f"train_{name}")))
    return [r[i] for r in ranks[0][world]], runs[i]


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("name", ("seqshard", "ring"))
@pytest.mark.parametrize("masked", (False, True))
def test_seq_attention_matches_jax(world, name, masked, files, ranks):
    got, _ = _results(ranks, world, "seq_ops", files)
    whole = [torch.cat([r[name, masked][i] for r in got], dim=1) for i in range(4)]
    want = files["ops"][world, name, masked]
    _close(whole[0], want[0], FWD)
    for g, w in zip(whole[1:], want[1:]):
        _close(g, w, GRAD)


@pytest.mark.parametrize("name,world", [(n, w) for n, _, _, ws in FORWARDS for w in ws])
def test_sharded_forward_matches_jax(name, world, files, ranks):
    got, _ = _results(ranks, world, "seq_forward", files, name)
    for out in got:  # the output is whole and the same on every rank
        _close(out, files["forward"][name], FWD)


def test_pipeline_over_data_and_seq_matches_jax_and_one_process(files, ranks):
    from pixart_sigma_tpu_torch.pipelines import PixArtPipeline

    got, run = _results(ranks, 4, "seq_pipeline", files)
    for r in got:
        _close(r["plain"], files["pipeline"], GRAD)  # JAX's tolerance for its pipeline
    model = tiny_seq_model(run["weights"], run["config"])
    data = {k: torch.from_numpy(v) for k, v in np.load(run["inputs"]).items()}
    calls = []
    model.blocks[1].register_forward_hook(lambda *a: calls.append(1))
    one = PixArtPipeline(model, base_resolution=256, device="cpu")(
        ["a", "b"], height=64, width=64, num_inference_steps=CACHED_STEPS, y=data["y"],
        y_mask=data["y_mask"], y_null=data["y_null"], latents=data["latents"],
        return_latents=True, block_cache_threshold=THRESHOLD)
    assert 2 < len(calls) < CACHED_STEPS  # some calls reused the cache
    for r in got:  # every rank took one process's refresh decisions
        assert r["span_calls"] == len(calls)
        _close(r["cached"], one, GRAD)


@pytest.fixture(scope="module")
def references(ranks):
    """One process's Trainer runs at the global batch of 4, without and with
    the features of the "features" cases, and on the wide bucket with the
    gather_first cases' compression."""
    root, wide = ranks[1]
    return {name: _reference(r, name, **extra)
            for name, r, extra in (("one", root, {}), ("one_features", root, FEATURES),
                                   ("one_gather_first", wide, GATHER_FIRST))}


@pytest.mark.parametrize("world,case", [(w, c) for w in (2, 4) for c in sorted(TRAINER_CASES[w])])
def test_trainer_over_seq_matches_one_process(world, case, ranks, files, references):
    """The losses, the gradient norms (a seq sum, not a mean), parameters,
    EMA and validation latents of one process at the global batch of 4."""
    got, run = _results(ranks, world, "trainer", files, case)
    suffix = next((s for s in ("features", "gather_first") if case.endswith(s)), None)
    reference = references["one" if suffix is None else f"one_{suffix}"]
    check_against_reference(got, reference, run["work_dir"])
    assert [r["batch_rank"] for r in got] == BATCH_RANKS.get(case, [0] * world)
    if "fsdp" in case:  # sharded over fsdp 2 (tests/test_torch_parallel_hsdp.py's bound)
        assert all(r["bytes"] < 0.6 * r["total_bytes"] for r in got)
    if suffix == "gather_first":  # the wide bucket's 12 x 20 grid, compressed after the gather
        assert all(h["hw"] == (24, 40) for r in got for h in r["history"])
        layer = SelfAttentionKVCompress(8, 2, sampling="conv", sr_ratio=4)
        layer.seq = SeqContext(None, 2, 0)
        assert not layer._local_rows(12, 20)


def test_seq_with_tensor_holds_what_tensor_alone_holds(files, ranks):
    """tensor 2 x seq 2 keeps on each rank the bytes of parameters,
    optimizer state and EMA that tensor 2 alone keeps; tensor 2's layers
    gather their whole outputs (qkv, q_linear, kv_linear) in the forward
    and in the recompute of each block, and their slices of the row layers'
    whole inputs (proj twice) in the backward, through `parallel.dist`:
    3 steps x 2 blocks x (3 + 3 + 2) all-gathers, and no other of its
    collectives (fc1 and fc2 keep the MLP's hidden features sharded)."""
    tensor2, _ = _results(ranks, 2, "trainer", files, "tensor2")
    both, _ = _results(ranks, 4, "trainer", files, "tensor2_seq2")
    assert {r["bytes"] for r in both} == {r["bytes"] for r in tensor2}
    assert len({r["bytes"] for r in tensor2}) == 1
    assert tensor2[0]["bytes"] < 0.8 * tensor2[0]["total_bytes"]
    for r in tensor2:
        assert r["transports"] == {"all_gather native": 3 * 2 * (3 + 3 + 2)}


@pytest.mark.parametrize("world", (2, 4))
def test_the_traps(world, files, ranks):
    got, _ = _results(ranks, world, "seq_traps", files)
    a = [np.asarray([1.0 + r, -2.0 * r]) for r in range(world)]
    b = [np.asarray([3.0, 1.0 + r]) for r in range(world)]
    mean = lambda xs: np.mean(np.abs(np.concatenate(xs)))
    ratio = mean(a) / (mean(b) + 1e-8)
    for r, res in enumerate(got):
        # the replicated output's gather: rank r's own slice of the weights
        # (2r + 1, 2r + 2), not world times it
        want = torch.tensor([2.0 * r + 1, 2.0 * r + 2])[None, :, None].expand(1, 2, 3)
        assert torch.equal(res["gather_grad"], want)
        assert float(res["shifted"]) == (r - 1) % world
        assert float(res["shift_grad"]) == (r + 1) % world + 1
        assert float(res["ratio"]) == pytest.approx(ratio, rel=1e-6)  # the global, on every rank
        # the K/V gather: every rank's rows in order; each rank's slice of the
        # gradient summed over the ranks (weighed by rank + 1: n(n+1)/2)
        assert torch.equal(res["kv"], torch.arange(world).repeat_interleave(2)[None, :, None]
                           .expand(1, 2 * world, 3).float())
        assert torch.equal(res["kv_grad"], want * world * (world + 1) / 2)
        assert set(res["transports"]) == {"all_gather native", "reduce_scatter native",
                                          "send/recv native"}
