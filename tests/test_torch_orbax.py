"""The port's orbax reader (`utils/ocdbt.py`, `utils/zarr.py`, `utils/orbax.py`,
`utils/checkpoint.py:load_orbax_params`) against orbax, tensorstore and the
JAX package, on the CPU.

- The committed fixture (`tests/fixtures/orbax_small`, written by the JAX
  package's `save_train_state` through `tests/torch_orbax_fixture.py`) reads
  leaf for leaf to `expected.json`'s SHA-256 digests, and the loaded port
  model's f32 output matches the JAX model's (1e-5 relative L2, as the
  port's other f32 forward checks).
- Every key and value of three OCDBT stores equals tensorstore's `kv.list()`
  and `kv.read()`: the fixture; an orbax save made here with an array
  sharded over 2 of the 8 host devices (two chunks), a bf16 leaf, scalars,
  inline (<= 1024 bytes) and indirect values; and a store that tensorstore
  writes with 600-byte nodes, whose root is interior. Orbax itself writes
  no interior node in practice: its `max_decoded_node_bytes` is 100 MB, and
  the fixture's root node, every key of a CAME train state, decodes to
  about 80 KB; PixArt-Sigma-XL-2's is about 4x that.
- `load_orbax_params` equals the JAX package's bit for bit from a `step_N`,
  `checkpoints/` or run directory, with and without `load_ema`, and after
  the re-split of a `cache_span` model.
- PixArt-Sigma-XL-2 with KV compression at depth 28, by `jax.eval_shape`:
  the map covers every parameter and CAME statistic at its shape.
- zarr's chunk grid (edge chunks, a chunk never written, C and F order, the
  dtypes) on a dict store; `latest_checkpoint` over both formats; a
  missing marker or manifest, or a damaged node, raises by name.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses
import hashlib
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch

from pixart_sigma_tpu.config import read_config as jax_read_config
from pixart_sigma_tpu.models.builder import build_model_from_config as jax_build_model
from pixart_sigma_tpu.training import TrainState as JaxTrainState
from pixart_sigma_tpu.training import build_optimizer as jax_build_optimizer
from pixart_sigma_tpu.utils import checkpoint as jckpt
from pixart_sigma_tpu_torch.config import read_config
from pixart_sigma_tpu_torch.models.builder import build_model_from_config
from pixart_sigma_tpu_torch.training.optim import _came_view, block_stacks, jax_layout
from pixart_sigma_tpu_torch.utils import checkpoint as ckpt
from pixart_sigma_tpu_torch.utils import orbax
from pixart_sigma_tpu_torch.utils.checkpoint import jax_param_path
from pixart_sigma_tpu_torch.utils.ocdbt import OcdbtError, OcdbtStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "orbax_small")
FIXTURE_CONFIG = os.path.join(FIXTURE, "config.py")
STEP_DIR = os.path.join(FIXTURE, "checkpoints", "step_2")
SIGMA_1024_KV = os.path.join(
    ROOT, "configs/pixart_sigma_config/PixArt_sigma_xl2_img1024_internalms_kvcompress.py")


def _expected():
    with open(os.path.join(FIXTURE, "expected.json")) as f:
        return json.load(f)


def _node(tree, path):
    for k in path:
        tree = tree[int(k)] if k.isdigit() else tree[k]
    return tree


def _bits(a):
    """An array's C-order bytes (bf16 tensors through their 16 bits)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        a = a.view(np.int16)
    return np.ascontiguousarray(a).tobytes()


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_the_fixture_reads_to_its_digests_and_output():
    expected = _expected()
    tree = orbax.read_tree(STEP_DIR)
    assert int(tree["step"]) == expected["step"] == 2
    for leaf in expected["leaves"]:
        arr = np.ascontiguousarray(_node(tree, leaf["path"]))
        assert [list(arr.shape), str(arr.dtype)] == [leaf["shape"], leaf["dtype"]], leaf["path"]
        assert hashlib.sha256(arr.tobytes()).hexdigest() == leaf["sha256"], leaf["path"]
    n_leaves = sum(1 for _ in _walk(tree))
    assert n_leaves == len(expected["leaves"])
    model = build_model_from_config(read_config(FIXTURE_CONFIG), device="cpu")
    ckpt.load_checkpoint(FIXTURE, model)  # the run directory
    inp = {k: torch.tensor(v) for k, v in expected["inputs"].items()}
    with torch.no_grad():
        out = model(inp["x"], inp["t"], inp["y"], inp["mask"]).numpy()
    assert _rel_l2(out, expected["output"]) <= 1e-5, _rel_l2(out, expected["output"])


def _walk(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _walk(v)
    else:
        yield tree


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{name: directory} of three OCDBT stores: the fixture, an orbax save of
    a sharded array, bf16 and scalar leaves, and a tensorstore store with
    interior nodes."""
    import orbax.checkpoint as ocp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    tmp = tmp_path_factory.mktemp("ocdbt")
    rng = np.random.RandomState(0)
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    tree = {
        "sharded": jax.device_put(jnp.asarray(rng.randn(16, 300).astype(np.float32)),
                                  NamedSharding(mesh, PartitionSpec("x", None))),
        "weights": {"bf16": jnp.asarray(rng.randn(40, 30), jnp.bfloat16),
                    "small": jnp.asarray(rng.randn(3).astype(np.float32)),
                    "ints": jnp.arange(12, dtype=jnp.int32).reshape(3, 4),
                    "mask": jnp.asarray(rng.rand(5, 7) > 0.5)},
        "count": jnp.asarray(7, jnp.int32),
        "scale": jnp.asarray(0.5, jnp.float32),
    }
    saved = str(tmp / "saved" / "step_7")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(saved, tree)
    ckptr.wait_until_finished()
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp}/interior/",
                          "config": {"max_decoded_node_bytes": 600,
                                     "max_inline_value_bytes": 32}}).result()
    with ts.Transaction() as txn:
        for i in range(150):
            kv.with_transaction(txn)[f"params.blocks_{i:03d}.attn/{'x' * (i % 7)}"] = \
                rng.bytes(int(rng.randint(0, 80)))
    return {"fixture": STEP_DIR, "saved": saved, "interior": str(tmp / "interior")}


@pytest.mark.parametrize("name", ["fixture", "saved", "interior"])
def test_every_key_and_value_equal_tensorstore(stores, name):
    root = stores[name]
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/"}).result()
    want = sorted(k.decode() for k in kv.list().result())
    store = OcdbtStore(root)
    assert store.keys() == want and len(want) >= 12
    for key in want:
        assert store.read(key) == kv.read(key).result().value, key
    sizes = [len(store.read(k)) for k in want]
    assert max(sizes) > store.max_inline_value_bytes  # some values are indirect
    assert store.read("no/such/key") is None
    if name == "interior":
        assert store.root_height >= 2
    else:  # orbax's nodes split only past 100 MB decoded
        assert store.root_height == 0 and store.max_decoded_node_bytes == 100_000_000


def test_sharded_bf16_and_scalar_leaves_equal_orbax(stores):
    import orbax.checkpoint as ocp

    saved = stores["saved"]
    store = OcdbtStore(saved)
    assert {"sharded/0.0", "sharded/1.0", "count/0"} <= set(store.keys())  # two chunks
    want = ocp.PyTreeCheckpointer().restore(saved)
    got = orbax.read_tree(saved)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = _node(got, [str(k.key) for k in path])
        assert tuple(g.shape) == np.asarray(w).shape, path
        assert _bits(g) == _bits(w), path
    assert isinstance(got["weights"]["bf16"], torch.Tensor)
    assert got["weights"]["bf16"].dtype == torch.bfloat16
    assert got["weights"]["mask"].dtype == np.bool_ and int(got["count"]) == 7
    assert orbax.read_tree(saved, "count") == 7


@pytest.mark.parametrize("load_ema", [False, True])
@pytest.mark.parametrize("where", ["step", "checkpoints", "run"])
def test_load_orbax_params_equals_jax(where, load_ema):
    src = {"step": STEP_DIR, "checkpoints": os.path.dirname(STEP_DIR), "run": FIXTURE}[where]
    want = jckpt.load_orbax_params(src, load_ema=load_ema)
    got = ckpt.load_orbax_params(src, load_ema=load_ema)
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == sum(1 for _ in _walk(got))
    for path, w in leaves:
        assert _bits(_node(got, [k.key for k in path])) == _bits(w), path
    other = ckpt.load_orbax_params(src, load_ema=not load_ema)
    assert not np.array_equal(other["t_block"]["kernel"], got["t_block"]["kernel"])


def test_cache_span_resplit_equals_jax_and_keeps_the_weights(tmp_path):
    """A save of the fixture's model without KV compression at depth 4 (one
    scan stack; JAX's re-split, like the port's, joins stacks of one
    structure only) into a `cache_span=(1, 3)` model: three stacks."""
    from pixart_sigma_tpu.models.pixart import PixArt as JaxPixArt

    overrides = dict(depth=4, kv_compress_layers=(), kv_compress_sampling=None)
    jcfg = dataclasses.replace(jax_build_model(jax_read_config(FIXTURE_CONFIG)).cfg, **overrides)
    params = jax.jit(JaxPixArt(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 8, 32)),
        jnp.ones((1, 8), jnp.int32))["params"]
    state = JaxTrainState.create(params=params, tx=jax_build_optimizer(
        name="adamw", learning_rate=1e-3), ema=False)
    path = jckpt.save_train_state(str(tmp_path / "checkpoints"), state)
    jspan = dataclasses.replace(jcfg, cache_span=(1, 3))
    want = jckpt.load_checkpoint(path, jspan)
    assert [jax.tree_util.tree_leaves(want[f"blocks_scan_{g}"])[0].shape[0]
            for g in range(3)] == [1, 2, 1]
    config = read_config(FIXTURE_CONFIG)
    config.kv_compress = False
    config.model_overrides = dict(config.model_overrides, depth=4)
    span_model = build_model_from_config(config, device="cpu", cache_span=(1, 3))
    got = ckpt.repartition_scan_params(ckpt.load_orbax_params(path), span_model.cfg)
    for key_path, w in jax.tree_util.tree_leaves_with_path(want):
        assert _bits(_node(got, [k.key for k in key_path])) == _bits(w), key_path
    ckpt.load_checkpoint(str(tmp_path), span_model)
    plain = ckpt.load_checkpoint(path, build_model_from_config(config, device="cpu"))
    for (n, a), (_, b) in zip(span_model.state_dict().items(), plain.state_dict().items()):
        assert torch.equal(a, b), n
    with pytest.raises(ValueError, match="different structures"):  # the KV-compressed fixture
        kv_span = build_model_from_config(read_config(FIXTURE_CONFIG), device="cpu",
                                          cache_span=(1, 3))
        ckpt.load_checkpoint(STEP_DIR, kv_span)


class _DictStore(dict):
    def read(self, key):
        return self.get(key)


@pytest.mark.parametrize("order", ["C", "F"])
def test_zarr_chunk_grid_edges_fill_and_dtypes(order):
    """Edge chunks, a chunk never written (the fill value), both orders and
    the dtypes orbax writes, on a plain dict store (zstd and no compressor)."""
    import zstandard

    from pixart_sigma_tpu_torch.utils.zarr import ZarrError, read_array

    rng = np.random.RandomState(3)
    cases = {"<f4": rng.randn(7, 5).astype(np.float32), "<f2": rng.randn(7, 5).astype(np.float16),
             "<i8": rng.randint(-9, 9, (7, 5)).astype(np.int64), "|b1": rng.rand(7, 5) > 0.5,
             "<i4": rng.randint(-9, 9, (7, 5)).astype(np.int32)}
    for dtype, want in cases.items():
        for compressor in (None, {"id": "zstd", "level": 1}):
            store = _DictStore()
            fill = {"|b1": False}.get(dtype, 3)
            store["a/.zarray"] = json.dumps(dict(
                zarr_format=2, shape=[7, 5], chunks=[3, 2], dtype=dtype, order=order,
                compressor=compressor, filters=None, fill_value=fill,
                dimension_separator=".")).encode()
            expect = want.copy()
            for i in range(3):
                for j in range(3):
                    if (i, j) == (1, 1):
                        expect[3:6, 2:4] = fill  # never written
                        continue
                    chunk = np.zeros((3, 2), want.dtype)
                    part = want[i * 3:(i + 1) * 3, j * 2:(j + 1) * 2]
                    chunk[:part.shape[0], :part.shape[1]] = part
                    raw = chunk.tobytes(order=order)
                    if compressor:
                        raw = zstandard.ZstdCompressor(level=1).compress(raw)
                    store[f"a/{i}.{j}"] = raw
            got = read_array(store, "a")
            assert got.dtype == want.dtype and np.array_equal(got, expect), (dtype, compressor)
    store = _DictStore({"b/.zarray": json.dumps(dict(
        zarr_format=2, shape=[2], chunks=[2], dtype="<f4", compressor={"id": "blosc"},
        filters=None, fill_value=0, order="C")).encode()})
    with pytest.raises(ZarrError, match="blosc"):
        read_array(store, "b")


def test_latest_checkpoint_takes_the_largest_step_of_either_format(tmp_path):
    """The port's `.pth` and JAX's `step_N`; at a tie the `.pth`."""
    (tmp_path / "step_3").mkdir()
    assert ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "step_3")
    (tmp_path / "epoch_1_step_3.pth").write_bytes(b"")
    assert ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "epoch_1_step_3.pth")
    (tmp_path / "step_10").mkdir()
    (tmp_path / "epoch_2_step_9.pth").write_bytes(b"")
    assert ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "step_10")
    assert orbax.latest_step_dir(str(tmp_path)) == str(tmp_path / "step_10")
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None


def test_a_missing_or_damaged_checkpoint_raises_by_name(tmp_path):
    model = build_model_from_config(read_config(FIXTURE_CONFIG), device="cpu")
    empty = tmp_path / "run" / "checkpoints" / "step_10"
    empty.mkdir(parents=True)
    for src in (empty, tmp_path / "run"):
        with pytest.raises(FileNotFoundError, match="_CHECKPOINT_METADATA"):
            ckpt.load_orbax_params(str(src))
    with pytest.raises(FileNotFoundError, match="_CHECKPOINT_METADATA"):
        ckpt.load_checkpoint(str(empty), model)
    copy = tmp_path / "copy"
    shutil.copytree(STEP_DIR, copy)
    os.remove(copy / "manifest.ocdbt")
    with pytest.raises(FileNotFoundError, match="manifest"):
        ckpt.load_checkpoint(str(copy), model)
    shutil.rmtree(copy)
    shutil.copytree(STEP_DIR, copy)
    root = next((copy / "d").iterdir())
    raw = bytearray(root.read_bytes())
    raw[40] ^= 1
    root.write_bytes(bytes(raw))
    with pytest.raises(OcdbtError, match="CRC-32C"):
        ckpt.load_checkpoint(str(copy), model)


def test_xl2_map_covers_every_parameter_and_came_statistic():
    """Shapes only: JAX's TrainState (CAME behind a clip, EMA) of
    PixArt-Sigma-XL-2 with KV compression at depth 28 by `jax.eval_shape`;
    the port's model on the meta device."""
    jmodel = jax_build_model(jax_read_config(SIGMA_1024_KV))
    assert (jmodel.cfg.depth, jmodel.cfg.hidden_size) == (28, 1152)

    def init():
        params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                             jnp.zeros((1, 300, 4096)), jnp.ones((1, 300), jnp.int32))["params"]
        tx = jax_build_optimizer(name="came", learning_rate=2e-5, grad_clip_norm=0.01)
        return JaxTrainState.create(params=params, tx=tx, ema=True)

    state = jax.eval_shape(init)
    came = state.opt_state[1]
    model = build_model_from_config(read_config(SIGMA_1024_KV), device="meta", train=True)
    cfg = model.cfg
    named = list(model.named_parameters())
    stacks = {s[0]: s for s in block_stacks([n for n, _ in named], cfg.block_groups())}
    followers = {n for s in stacks.values() for n in s[1:]}
    zeros = lambda shape: np.broadcast_to(np.zeros((), np.float32), shape)
    jax_paths = {"/".join(k.key for k in path)
                 for path, _ in jax.tree_util.tree_leaves_with_path(state.params)}
    covered = set()
    for n, p in named:
        if n in followers:
            continue
        path = jax_param_path(n, cfg)
        covered.add(path)
        view = tuple(jax_layout(n, p).shape)
        if n in stacks:
            view = (len(stacks[n]),) + view
        leaf = lambda tree: _node(tree, path.split("/"))
        assert leaf(state.params).shape == leaf(state.ema_params).shape
        key, v = _came_view(n, p, path, zeros(leaf(came.exp_avg).shape), "full", cfg)
        assert (key, v.shape) == ("exp_avg", view), n
        assert _came_view(n, p, path, zeros(leaf(state.params).shape), "full", cfg)[1].shape \
            == view
        if len(view) >= 2:
            want = {"row": view[:-1], "col": view[:-2] + view[-1:]}
            for kind, tree in (("row", came.row), ("col", came.col), ("row", came.res_row),
                               ("col", came.res_col)):
                key, v = _came_view(n, p, path, zeros(leaf(tree).shape), kind, cfg)
                assert v.shape == want[key], (n, kind)
        else:
            assert _came_view(n, p, path, zeros(leaf(came.row).shape), "row", cfg)[1].shape \
                == view
    assert covered == jax_paths
    assert sum(p.numel() for _, p in named) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(state.params))
