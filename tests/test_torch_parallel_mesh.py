"""The port's parallelism rules against the JAX package's, with no process
group: `MeshConfig.resolve`, the FSDP and tensor-parallel placement of
every parameter of a tiny KV-compress model (`param_placement` read back
onto the torch tensors, against JAX's `param_sharding` specs), the
per-rank batch sampler, the process-pool loader, and what still raises
(a `seq` axis, `--seq-parallel`, the parallelism keys without ranks).
The multi-rank runs are in tests/test_torch_parallel_{step,train,hsdp,
resume}.py.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.data.sampler import ShardedBatchSampler as JaxShardedBatchSampler
from pixart_sigma_tpu.models.pixart import PixArt as JaxPixArt
from pixart_sigma_tpu.models.pixart import PixArtConfig as JaxConfig
from pixart_sigma_tpu.parallel import mesh as jax_mesh
from pixart_sigma_tpu_torch.config import read_config
from pixart_sigma_tpu_torch.data.datasets import PixArtMSDataset
from pixart_sigma_tpu_torch.data.loader import DataLoader
from pixart_sigma_tpu_torch.data.sampler import AspectRatioBatchSampler, ShardedBatchSampler
from pixart_sigma_tpu_torch.data.aspect import aspect_ratio_table
from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset
from pixart_sigma_tpu_torch.models.pixart import PixArtConfig, PixArtMS_XL_2
from pixart_sigma_tpu_torch.parallel import dist as pdist
from pixart_sigma_tpu_torch.parallel import mesh as tmesh
from pixart_sigma_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = os.path.join(ROOT, "configs/toy/pixart_toy_img128.py")
# as tests/test_fsdp_multiprocess.py cuts the model: depth 2, width 128,
# 4 heads, caption 64; KV compression on the second layer
TINY = dict(depth=2, hidden_size=128, num_heads=4, caption_channels=64, model_max_length=8,
            kv_compress_sampling="conv", kv_compress_scale=2, kv_compress_layers=(1,))
MIN_SIZE = 4096


@pytest.mark.parametrize("n,config", [
    (8, dict()), (8, dict(fsdp=2)), (8, dict(data=2, fsdp=4)), (8, dict(fsdp=2, tensor=2)),
    (4, dict(data=2, fsdp=2)), (2, dict(tensor=2)), (1, dict()), (1, dict(data=1)),
    (6, dict(fsdp=4)), (8, dict(data=3, fsdp=2)), (2, dict(data=1)),
])
def test_mesh_config_resolves_as_jax(n, config):
    """The same sizes, or the same AssertionError text."""
    want = got = None
    try:
        want = jax_mesh.MeshConfig(**config).resolve(n)
    except AssertionError as e:
        want = ("raises", str(e))
    try:
        got = tmesh.MeshConfig(**config).resolve(n)
    except AssertionError as e:
        got = ("raises", str(e))
    assert got == want


def _models(scan_blocks):
    """(JAX param tree, port model) of the tiny KV-compress model."""
    jcfg = JaxConfig(**TINY, dtype=jnp.float32, scan_blocks=scan_blocks)
    x = jnp.zeros((1, 8, 8, 4))
    params = jax.eval_shape(lambda: JaxPixArt(jcfg).init(
        jax.random.PRNGKey(0), x, jnp.zeros((1,)), jnp.zeros((1, 8, 64)),
        jnp.ones((1, 8), jnp.int32)))["params"]
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    cfg = PixArtConfig(**kw, dtype=torch.float32)
    model = PixArtMS_XL_2(device="meta", train=True,
                          **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    return params, model


def _jax_specs(params, mesh, **kw):
    """{JAX path: (leaf shape, its PartitionSpec)}."""
    specs = jax_mesh.param_sharding(params, mesh, min_size=MIN_SIZE, **kw)
    out = {}
    for (path, leaf), spec in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                                  jax.tree_util.tree_leaves(specs)):
        out["/".join(jax_mesh._path_names(path))] = (tuple(leaf.shape), tuple(spec.spec))
    return out


def _axis(spec, name):
    """The leaf axis sharded over mesh axis `name` in a spec, or None."""
    for i, axes in enumerate(spec):
        if axes == name or (isinstance(axes, tuple) and name in axes):
            return i
    return None


def _check_against_jax(scan_blocks, fsdp_size, tp_size):
    from pixart_sigma_tpu_torch.utils.checkpoint import jax_param_path

    params, model = _models(scan_blocks)
    mesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(fsdp=fsdp_size, tensor=tp_size))
    fsdp, tensor = fsdp_size > 1, tp_size > 1
    want = _jax_specs(params, mesh, fsdp=fsdp, tensor=tensor)
    n_fsdp = n_tp = 0
    for name, p in model.named_parameters():
        jshape, to_torch = tmesh.jax_leaf(name, p.shape, model.cfg)
        shape, spec = want[jax_param_path(name, model.cfg)]
        assert jshape == shape, name
        got = tmesh.param_placement(name, p.shape, model.cfg, fsdp_size=fsdp_size,
                                    tp_size=tp_size, fsdp=fsdp, tensor=tensor,
                                    min_size=MIN_SIZE)
        for axis_name in ("fsdp", "tensor"):
            axis = _axis(spec, axis_name)
            assert got[axis_name] == (None if axis is None else to_torch[axis]), (
                name, axis_name, spec)
        n_fsdp += got["fsdp"] is not None
        n_tp += got["tensor"] is not None
    return n_fsdp, n_tp


@pytest.mark.parametrize("scan_blocks", [True, False])
@pytest.mark.parametrize("fsdp_size", [2, 4])
def test_fsdp_placement_matches_jax(scan_blocks, fsdp_size):
    """Whether each parameter is sharded over fsdp, and along which torch
    dim, is JAX's choice (its leaf in the JAX layout, min_size 4096)."""
    n_fsdp, _ = _check_against_jax(scan_blocks, fsdp_size, 1)
    assert n_fsdp >= 10


@pytest.mark.parametrize("scan_blocks", [True, False])
@pytest.mark.parametrize("fsdp_size", [1, 2])
def test_tensor_placement_matches_jax(scan_blocks, fsdp_size):
    """The tensor axis of each parameter (JAX's `_tp_axis`), and with fsdp
    the largest remaining axis, as JAX composes them."""
    _, n_tp = _check_against_jax(scan_blocks, fsdp_size, 2)
    assert n_tp == 2 * 11  # per block: 4 column kernels + their biases, 3 row kernels


def test_y_proj_fc1_is_not_tensor_parallel():
    """JAX matches path suffixes: ("mlp", "fc1", "kernel"), which the
    caption projection's y_proj/fc1 is not."""
    _, model = _models(True)
    cfg = model.cfg
    place = lambda n: tmesh.param_placement(n, dict(model.named_parameters())[n].shape, cfg,
                                            tp_size=2, tensor=True)["tensor"]
    assert place("y_embedder.y_proj.fc1.weight") is None
    assert place("y_embedder.y_proj.fc2.weight") is None
    assert place("blocks.0.mlp.fc1.weight") == 0 and place("blocks.0.mlp.fc1.bias") == 0
    assert place("blocks.0.mlp.fc2.weight") == 1 and place("blocks.0.mlp.fc2.bias") is None
    assert jax_mesh._tp_axis(("y_embedder", "y_proj", "fc1", "kernel"), 2) is None


def test_one_rank_shards_what_two_ranks_shard():
    """Over one fsdp rank every axis divides: the same parameters are
    FSDP-managed as over two, so a one-card run drives the same code."""
    _, model = _models(True)
    for name, p in model.named_parameters():
        one = tmesh.param_placement(name, p.shape, model.cfg, fsdp_size=1, fsdp=True,
                                    min_size=MIN_SIZE)
        two = tmesh.param_placement(name, p.shape, model.cfg, fsdp_size=2, fsdp=True,
                                    min_size=MIN_SIZE)
        assert one == two, name


class _Buckets:
    """A dataset stand-in for the bucket samplers."""

    def __init__(self, n):
        rng = np.random.RandomState(0)
        self.ratios = [rng.choice([0.5, 1.0, 2.0]) for _ in range(n)]

    def __len__(self):
        return len(self.ratios)

    def get_data_info(self, i):
        return {"height": 256, "width": int(256 / self.ratios[i])}


@pytest.mark.parametrize("replicas", [2, 4])
def test_sharded_batch_sampler_matches_jax(replicas):
    from pixart_sigma_tpu.data.sampler import AspectRatioBatchSampler as JaxSampler

    table = aspect_ratio_table(256)
    ds = _Buckets(50)
    for epoch in (0, 1):
        got, want = [], []
        for r in range(replicas):
            port = ShardedBatchSampler(AspectRatioBatchSampler(ds, 2 * replicas, table, seed=5),
                                       2, replicas, r)
            jax_s = JaxShardedBatchSampler(JaxSampler(ds, 2 * replicas, table, seed=5), 2,
                                           replicas, r)
            port.set_epoch(epoch)
            jax_s.set_epoch(epoch)
            got.append(list(port))
            want.append(list(jax_s))
            assert len(port) == len(jax_s) == len(got[-1])
        assert got == want
        # the ranks' slices in rank order are the global batches
        glob = AspectRatioBatchSampler(ds, 2 * replicas, table, seed=5)
        glob.set_epoch(epoch)
        full = [b for b in glob if len(b) == 2 * replicas]
        assert [sum((got[r][i] for r in range(replicas)), []) for i in range(len(full))] == full


def test_process_loader_yields_the_thread_batches(tmp_path):
    """`loader_processes`: a spawn process pool gives the thread loader's
    batches bit for bit, the fast-forward included."""
    write_feature_dataset(str(tmp_path / "data"), [(256, 256)] * 6 + [(272, 240)] * 6,
                          resolution=256, caption_channels=16, max_length=8)
    ds = PixArtMSDataset(str(tmp_path / "data"), resolution=256, aspect_ratio_type=256,
                         max_length=8, load_vae_feat=True, load_t5_feat=True)
    table = aspect_ratio_table(256)
    batches = {}
    for procs in (False, True):
        loader = DataLoader(ds, AspectRatioBatchSampler(ds, 2, table, seed=1), num_workers=2,
                            skip_batches=1, use_processes=procs)
        batches[procs] = list(loader)
    assert len(batches[True]) == len(batches[False]) > 2
    for a, b in zip(batches[False], batches[True]):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k


def test_what_is_not_ported_still_raises(tmp_path):
    """A `seq` axis needs ranks, alone or with tensor parallelism, as the
    other axes do (--seq-parallel in tests/test_torch_serve.py): without a
    process group the Trainer raises and names them."""
    cfg = read_config(TOY)
    for mesh in (dict(data=-1, fsdp=1, tensor=2, seq=2), dict(data=-1, fsdp=1, tensor=1, seq=2)):
        cfg["mesh"] = mesh
        cfg["use_tensor_parallel"] = mesh["tensor"] > 1
        with pytest.raises(RuntimeError, match="acts on torch.distributed's ranks"):
            Trainer(cfg, str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="initialised process group"):
        tmesh.build_mesh(tmesh.MeshConfig(tensor=2, seq=2), "cpu")


def test_one_process_without_environment():
    """No process group and no torchrun environment: initialize_distributed
    is a no-op and the helpers answer for one process."""
    env = {k: os.environ.pop(k) for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")
           if k in os.environ}
    try:
        assert pdist.initialize_distributed(device="cpu") is False
    finally:
        os.environ.update(env)
    assert not torch.distributed.is_initialized()
    assert (pdist.process_index(), pdist.process_count(), pdist.is_main_process()) == (0, 1,
                                                                                        True)
    assert pdist.gather_cpu({"a": 1}) == [{"a": 1}]
    assert pdist.broadcast_object([3]) == [3]
    x = torch.arange(3.0)
    assert pdist.all_gather_tensor(x) is x
    assert pdist.reduce_dict({"a": x.sum()})["a"] == 3.0
    pdist.sync_global_devices()
