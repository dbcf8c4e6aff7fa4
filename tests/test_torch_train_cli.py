"""The port's training CLI (`pixart_sigma_tpu_torch.scripts.train`) on the
CPU, as JAX's scripts/train.py is driven.

- configs/toy/pixart_toy_img128.py in image mode (cut to depth 2), its VAE
  from a diffusers `.safetensors` of a random SDXL VAE and T5 from an HF
  directory (a toy `tokenizers` tokenizer and a tiny T5EncoderModel, random
  weights), with `--debug` (batch 2, log every step);
- `--load-from` a `.pth` and the diffusers `.safetensors` of the same
  weights give the same first-step loss, bit for bit;
- `--resume-from latest` after 2 steps gives the weights and EMA of 3
  uninterrupted steps, bit for bit;
- a `vae_pretrained` directory is read as `scripts.train_vae` writes it,
  and raises without its files;
- the five parallelism keys of the JAX trainer raise when they differ from
  their defaults, and no shipped config sets one.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import glob
import json
import os

import numpy as np
import pytest
import torch

from pixart_sigma_tpu_torch.config import read_config
from pixart_sigma_tpu_torch.data.synthetic import write_image_dataset
from pixart_sigma_tpu_torch.models import t5 as port_t5
from pixart_sigma_tpu_torch.models.builder import build_model_from_config
from pixart_sigma_tpu_torch.models.pixart import init_weights
from pixart_sigma_tpu_torch.models.vae import VAEConfig, build_vae
from pixart_sigma_tpu_torch.scripts import train as train_cli
from pixart_sigma_tpu_torch.training.trainer import Trainer, _needs_ranks
from pixart_sigma_tpu_torch.utils.checkpoint import (
    save_pth,
    save_safetensors,
    torch_to_diffusers_state_dict,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = os.path.join(ROOT, "configs/toy/pixart_toy_img128.py")
T5_DIM = 32


def _write_t5(path):
    """A toy HF tokenizer and a tiny random T5EncoderModel of width T5_DIM."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import T5Config as HFT5Config, T5EncoderModel

    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    for i in range(len(vocab), 128):
        vocab[f"tok{i}"] = i
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(single="$A </s>",
                                                       special_tokens=[("</s>", 1)])
    os.makedirs(path)
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>",
                   "eos_token": "</s>", "unk_token": "<unk>", "model_max_length": 512}, f)
    cfg = HFT5Config(vocab_size=128, d_model=T5_DIM, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
                     feed_forward_proj="gated-gelu", dropout_rate=0.0,
                     is_encoder_decoder=False, use_cache=False, tie_word_embeddings=False)
    torch.manual_seed(0)
    T5EncoderModel(cfg).save_pretrained(path, safe_serialization=True)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A random SDXL VAE `.safetensors`, a T5 directory, 4 PNGs with
    captions, and one set of random DiT weights as `.pth` and diffusers
    `.safetensors`, with the config that reads them."""
    d = tmp_path_factory.mktemp("cli")
    torch.manual_seed(1)
    vae = build_vae(VAEConfig.sdxl(), device="cpu")
    vae_path = save_safetensors(str(d / "vae.safetensors"), vae.state_dict())
    t5_path = _write_t5(str(d / "t5"))
    write_image_dataset(str(d / "data"), [(128, 128)] * 4)
    config = d / "toy_image.py"
    config.write_text(
        f"_base_ = [{TOY!r}]\n"
        f"data_root = {str(d)!r}\n"
        "data = dict(root='data', load_vae_feat=False, load_t5_feat=False)\n"
        f"vae_pretrained = {vae_path!r}\n"
        f"t5_pretrained = {t5_path!r}\n"
        f"model_overrides = dict(depth=2, hidden_size=64, num_heads=2, caption_channels={T5_DIM})\n"
        "num_workers = 2\nsave_model_epochs = 10**6\nvisualize = False\n"
        "lr_schedule_args = dict(num_warmup_steps=1)\n")
    cfg = read_config(str(config))
    model = build_model_from_config(cfg, device="cpu", train=True)
    init_weights(model, torch.Generator().manual_seed(5))
    with torch.no_grad():  # the zero-initialised projections, so the blocks matter
        for name, p in model.named_parameters():
            if name.endswith(("cross_attn.proj.weight", "final_layer.linear.weight")):
                p.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(6))
    pth = save_pth(str(d / "weights.pth"), model.state_dict())
    st = save_safetensors(str(d / "weights.safetensors"),
                          torch_to_diffusers_state_dict(model.state_dict()))
    return dict(dir=d, config=str(config), pth=pth, safetensors=st)


@pytest.fixture(autouse=True)
def small_t5(monkeypatch):
    """`T5Embedder.from_pretrained` builds T5-XXL; the test's checkpoint is tiny."""
    monkeypatch.setattr(port_t5.T5Config, "xxl", classmethod(
        lambda cls, **kw: cls.small_test(**dict(kw, d_model=T5_DIM))))


def _run(files, work, *extra):
    return train_cli.main([files["config"], "--work-dir", str(files["dir"] / work), "--debug",
                           "--device", "cpu", *extra])


def test_image_mode_through_main_and_load_from_either_format(files):
    a = _run(files, "from_pth", "--load-from", files["pth"], "--max-steps", "1")
    b = _run(files, "from_st", "--load-from", files["safetensors"], "--max-steps", "1")
    assert a.config.train_batch_size == 2 and a.config.log_interval == 1
    assert a.vae is not None and a.t5 is not None
    assert a.history[0]["hw"] == (16, 16) and np.isfinite(a.history[0]["loss"])
    assert a.history[0]["loss"] == b.history[0]["loss"]
    metrics = [json.loads(ln) for ln in open(files["dir"] / "from_pth" / "metrics.jsonl")]
    assert [m["step"] for m in metrics] == [1]


def test_resume_from_latest_is_bit_exact(files):
    whole = _run(files, "whole", "--load-from", files["pth"], "--max-steps", "3")
    part = _run(files, "part", "--load-from", files["pth"], "--max-steps", "2")
    part.save(part.state.step, 0)
    resumed = _run(files, "part", "--resume-from", "latest", "--max-steps", "1")
    assert resumed.config.resume_from == dict(checkpoint="latest", load_ema=False,
                                              resume_optimizer=True, resume_lr_scheduler=True)
    assert resumed.state.step == 3
    got = dict(resumed.model.named_parameters())
    for n, p in whole.model.named_parameters():
        assert torch.equal(p, got[n]), n
        assert torch.equal(whole.state.ema[n], resumed.state.ema[n]), n
    assert whole.history[2]["loss"] == resumed.history[0]["loss"]
    assert glob.glob(str(files["dir"] / "part" / "checkpoints" / "*.pth"))


def test_a_vae_directory_raises(files, tmp_path):
    """Without vae_config.json and vae_params.msgpack the directory raises;
    with them (as `scripts.train_vae` writes them) its VAE is loaded."""
    from pixart_sigma_tpu_torch.models.vae import save_flax_vae

    (tmp_path / "toy_vae").mkdir()
    config = tmp_path / "dir_vae.py"
    config.write_text(f"_base_ = [{files['config']!r}]\n"
                      f"vae_pretrained = {str(tmp_path / 'toy_vae')!r}\n")
    with pytest.raises(FileNotFoundError, match="vae_config.json"):
        train_cli.main([str(config), "--work-dir", str(tmp_path / "w"), "--device", "cpu"])
    vae = build_vae(VAEConfig.small_test(), device="cpu")
    save_flax_vae(vae, str(tmp_path / "toy_vae"))
    got = train_cli.load_vae(read_config(str(config)), torch.device("cpu"))
    assert got.cfg == vae.cfg
    for k, v in vae.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k


@pytest.mark.parametrize("key,value", [
    ("mesh", dict(data=-1, fsdp=2, tensor=1, seq=1)),
    ("use_fsdp", True),
    ("use_tensor_parallel", True),
    ("fsdp_min_size", 1024),
])
def test_parallelism_keys_away_from_their_defaults_raise(key, value, tmp_path):
    """They act on torch.distributed's ranks: without a process group they
    raise and say how to start one (the multi-rank runs are in
    tests/test_torch_parallel_*.py; `loader_processes` needs no ranks)."""
    cfg = read_config(TOY)
    cfg[key] = value
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        Trainer(cfg, str(tmp_path), device="cpu")


def test_no_shipped_config_sets_a_parallelism_key():
    paths = glob.glob(os.path.join(ROOT, "configs", "**", "*.py"), recursive=True)
    assert len(paths) > 10
    for path in paths:
        assert _needs_ranks(read_config(path)) is None, path
