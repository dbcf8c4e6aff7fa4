"""The port's leaf modules against the JAX package: the window helpers
(`ops/windows.py`), the auxiliary layers of models/layers.py with their
param converter (`utils.checkpoint.aux_state_dict_from_jax`, mirroring
tests/test_aux_layers.py), the profiling hooks on the CPU, and
`tools.memory_table` (per-rank bytes against JAX's tool and JAX's
`param_sharding`). f32; the layers within 1e-5 of JAX."""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import io
import json
import os
import runpy
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.models import layers as jl
from pixart_sigma_tpu.ops import windows as jw
from pixart_sigma_tpu_torch.models import layers as tl
from pixart_sigma_tpu_torch.ops import windows as tw
from pixart_sigma_tpu_torch.utils.checkpoint import aux_state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _close(got, want, tol=TOL):
    if torch.is_tensor(got):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("hw,ws", [((14, 14), 7), ((10, 13), 4)])
def test_window_partition_round_trip_matches_jax(hw, ws):
    x = np.random.RandomState(0).randn(2, *hw, 5).astype(np.float32)
    jwin, jpad = jw.window_partition(jnp.asarray(x), ws)
    twin, tpad = tw.window_partition(torch.from_numpy(x), ws)
    assert tuple(tpad) == tuple(jpad)
    _close(twin, jwin, 0)
    back = tw.window_unpartition(twin, ws, tpad, hw)
    _close(back, jw.window_unpartition(jwin, ws, jpad, hw), 0)
    _close(back, x, 0)


@pytest.mark.parametrize("q,k,length", [(7, 7, 13), (5, 5, 5), (4, 8, 15), (9, 9, 25)])
def test_decomposed_rel_pos_matches_jax(q, k, length):
    """The table as it is (13 rows for 7 x 7), stretched (5 -> 9 rows) and
    shrunk (25 -> 17: the widened filter), on square and unequal grids."""
    rng = np.random.RandomState(1)
    rel_h, rel_w = (rng.randn(length, 6).astype(np.float32) for _ in range(2))
    qs = rng.randn(2, q * q, 6).astype(np.float32)
    attn = rng.randn(2, q * q, k * k).astype(np.float32)
    _close(tw.get_rel_pos(q, k, torch.from_numpy(rel_h)), jw.get_rel_pos(q, k, jnp.asarray(rel_h)))
    want = jw.add_decomposed_rel_pos(jnp.asarray(attn), jnp.asarray(qs), jnp.asarray(rel_h),
                                     jnp.asarray(rel_w), (q, q), (k, k))
    got = tw.add_decomposed_rel_pos(*(torch.from_numpy(a) for a in (attn, qs, rel_h, rel_w)),
                                    (q, q), (k, k))
    _close(got, want)


def _port(module, params):
    module.load_state_dict(aux_state_dict_from_jax(params))
    return module.eval().requires_grad_(False)


def test_final_layers_match_jax():
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(2, 5, 32).astype(np.float32))
    tensor = lambda a: torch.from_numpy(np.array(a))
    c = jnp.asarray(rng.randn(2, 32).astype(np.float32))
    cw = jnp.asarray(rng.randn(2, 48).astype(np.float32))
    for jmod, tmod, cond in (
            (jl.FinalLayer(32, 2, 8), tl.FinalLayer(32, 2, 8), c),
            (jl.MaskFinalLayer(32, 2, 4), tl.MaskFinalLayer(32, 48, 2, 4), cw),
            (jl.DecoderLayer(32, 24), tl.DecoderLayer(32, 24), c)):
        params = jmod.init(jax.random.PRNGKey(3), x, cond)
        got = _port(tmod, params)(tensor(x), tensor(cond))
        _close(got, jmod.apply(params, x, cond))
        assert not torch.allclose(got, tmod(tensor(x), tensor(cond) + 1))


def test_label_embedder_matches_jax():
    jmod = jl.LabelEmbedder(num_classes=10, hidden_size=8, dropout_prob=0.5)
    labels = jnp.array([1, 2, 3, 4])
    params = jmod.init({"params": jax.random.PRNGKey(0), "label_drop": jax.random.PRNGKey(1)},
                       labels, True)
    tmod = _port(tl.LabelEmbedder(10, 8, dropout_prob=0.5), params)
    tlabels = torch.tensor([1, 2, 3, 4])
    assert tmod.embedding_table.weight.shape == (11, 8)
    for drop in (None, jnp.asarray([1, 0, 1, 0], jnp.int32)):
        want = jmod.apply(params, labels, False, force_drop_ids=drop)
        got = tmod(tlabels, False, None if drop is None else torch.from_numpy(np.array(drop)))
        _close(got, want, 0)
    with pytest.raises(ValueError, match="dropout_prob > 0"):
        tl.LabelEmbedder(10, 8)(tlabels, force_drop_ids=torch.ones(4, dtype=torch.int32))
    # training drops draw from the generator: each row is its label's or the null
    out = tmod(tlabels, True, generator=torch.Generator().manual_seed(0))
    table = tmod.embedding_table.weight
    assert all(torch.equal(o, table[lab]) or torch.equal(o, table[10])
               for o, lab in zip(out, tlabels.tolist()))


def test_caption_embedder_double_br_matches_jax():
    jmod = jl.CaptionEmbedderDoubleBr(in_channels=12, hidden_size=16, uncond_prob=0.5,
                                      token_num=6)
    cap = jax.random.normal(jax.random.PRNGKey(0), (3, 1, 6, 12))
    params = jmod.init({"params": jax.random.PRNGKey(1), "caption_drop": jax.random.PRNGKey(2)},
                       cap, True)
    tmod = _port(tl.CaptionEmbedderDoubleBr(12, 16, uncond_prob=0.5, token_num=6), params)
    tcap = torch.from_numpy(np.array(cap))
    for drop in (None, jnp.asarray([1, 0, 1], jnp.int32)):
        want_y, want_cap = jmod.apply(params, cap, False, force_drop_ids=drop)
        got_y, got_cap = tmod(tcap, False,
                              None if drop is None else torch.from_numpy(np.array(drop)))
        _close(got_y, want_y)
        _close(got_cap, want_cap, 0)
    # a [B, L, C] caption gains its branch axis, as in JAX
    assert tmod(tcap[:, 0])[1].shape == (3, 1, 6, 12)


def test_profiling_hooks_on_the_cpu(tmp_path):
    from pixart_sigma_tpu_torch.utils.profiling import StepTimer, annotate, trace

    timer = StepTimer(skip_first=1)
    for _ in range(3):
        with timer:
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert timer.count == 3 and timer.total > 0 and timer.mean_ms == timer.total / 2 * 1000
    with trace(str(tmp_path / "prof")) as prof:
        with annotate("pixart_step"):
            torch.ones(8, 8).sum()
    events = json.load(open(tmp_path / "prof" / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "pixart_step" for e in events)
    assert any(e.key == "pixart_step" for e in prof.key_averages())
    with trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not os.path.exists(tmp_path / "off")


MESHES = "2,2,2;1,4,2"


def test_memory_table_matches_jax():
    """The port's table equals the JAX tool's on two (data, fsdp, tensor)
    triples, and its parameter bytes per rank equal the bytes of one
    device's shards under JAX's `param_sharding` on those 8-device meshes."""
    from pixart_sigma_tpu.models.pixart import PixArt, PixArtConfig
    from pixart_sigma_tpu.parallel.mesh import MeshConfig, build_mesh, param_sharding
    from pixart_sigma_tpu_torch.tools import memory_table

    argv = sys.argv
    out = io.StringIO()
    try:
        sys.argv = ["memory_table.py", "--meshes", MESHES]
        with redirect_stdout(out):
            runpy.run_path(os.path.join(ROOT, "tools", "memory_table.py"), run_name="__main__")
    finally:
        sys.argv = argv
    got = io.StringIO()
    with redirect_stdout(got):
        memory_table.main(["--meshes", MESHES])
    assert got.getvalue() == out.getvalue() and out.getvalue().count("GiB") == 8

    cfg = PixArtConfig(input_size=128, model_max_length=300, pe_interpolation=2.0,
                       dtype=jnp.bfloat16)
    params = jax.eval_shape(lambda: PixArt(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 4), jnp.bfloat16), jnp.zeros((1,)),
        jnp.zeros((1, 300, 4096), jnp.bfloat16), jnp.ones((1, 300), jnp.int32))["params"])
    leaves = memory_table.jax_leaves(1024)
    for d, f, t in ((2, 2, 2), (1, 4, 2)):
        shardings = param_sharding(params, build_mesh(MeshConfig(data=d, fsdp=f, tensor=t)),
                                   fsdp=True, tensor=True)
        want = sum(int(np.prod(s.shard_shape(p.shape))) * 4 for p, s in zip(
            jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(shardings)))
        assert memory_table.sharded_bytes(leaves, f, t) == want
