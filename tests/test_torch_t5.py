"""The port's T5 encoder against the JAX package, on the CPU.

- `relative_position_bucket` equal to JAX's at the 120- and 300-token
  caption lengths;
- `T5Encoder` at `small_test` widths, 3 layers, with a padded mask, from
  the same perturbed JAX params (`t5_state_dict_from_jax`): relative L2
  <= 1e-5 in f32 and <= 2e-2 in bf16 compute;
- `T5Embedder` against JAX's with one toy tokenizer object given to both
  (caption cleaning, padding, truncation);
- `t5_state_dict_from_jax` inverts `hf_t5_to_flax` exactly, and the port's
  module names are HF `T5EncoderModel`'s: an HF encoder's state dict loads
  and gives HF's hidden states, through `T5Embedder.from_pretrained` too.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.models.t5 import T5Config as JaxT5Config
from pixart_sigma_tpu.models.t5 import T5Embedder as JaxT5Embedder
from pixart_sigma_tpu.models.t5 import T5Encoder as JaxT5Encoder
from pixart_sigma_tpu.models.t5 import hf_t5_to_flax
from pixart_sigma_tpu.models.t5 import relative_position_bucket as jax_bucket
from pixart_sigma_tpu_torch.models.t5 import (
    T5Config,
    T5Embedder,
    build_t5,
    init_weights,
    relative_position_bucket,
)
from pixart_sigma_tpu_torch.utils.checkpoint import t5_state_dict_from_jax

LAYERS = 3


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_params(cfg, seed=0):
    """Seeded random JAX T5 params shaped by abstract evaluation of the
    initialiser: kernels N(0, 1/fan_in), the embedding N(0, 1), the bias
    table N(0, 0.5^2), norm weights perturbed around 1."""
    shapes = jax.eval_shape(JaxT5Encoder(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.randn(*leaf.shape).astype(np.float32)
        if name == "kernel":
            return jnp.asarray(x / np.sqrt(leaf.shape[0]))
        if name == "weight":
            return jnp.asarray(1.0 + 0.1 * x)
        return jnp.asarray(0.5 * x if name == "relative_attention_bias" else x)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _inputs(B=3, L=20, vocab=128, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, L))
    lengths = np.asarray([L, 11, 4])[:B]
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int64)
    return ids * mask, mask


class WordHashTokenizer:
    """A toy tokenizer called as an HF one: each word's id in [2, vocab) from
    a stable hash, EOS 1 appended, padded with 0 to max_length, truncated
    before the EOS."""

    def __init__(self, vocab_size: int = 128):
        self.vocab_size = vocab_size

    def __call__(self, texts, max_length, padding, truncation, return_tensors):
        assert padding == "max_length" and truncation and return_tensors == "np"
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            toks = [2 + sum(w.encode()) * 31 % (self.vocab_size - 2) for w in text.split()]
            toks = toks[: max_length - 1] + [1]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


@pytest.mark.parametrize("L", [120, 300])
def test_relative_position_bucket_matches_jax(L):
    pos = np.arange(L)
    rel = pos[None, :] - pos[:, None]
    for buckets, dist in ((32, 128), (16, 64)):
        np.testing.assert_array_equal(relative_position_bucket(rel, buckets, dist),
                                      jax_bucket(rel, buckets, dist))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_t5_encoder_matches_jax(dtype, tol):
    """3 layers at small_test widths, captions of 20, 11 and 4 valid tokens
    out of 20; f32 params, compute in `dtype` on both sides."""
    jcfg = JaxT5Config.small_test(num_layers=LAYERS, dtype=getattr(jnp, dtype))
    params = _jax_params(jcfg)
    ids, mask = _inputs()
    want = jax.jit(lambda p, i, m: JaxT5Encoder(jcfg).apply({"params": p}, i, m))(
        params, jnp.asarray(ids), jnp.asarray(mask))
    cfg = T5Config.small_test(num_layers=LAYERS, dtype=getattr(torch, dtype))
    enc = build_t5(cfg, device="cpu", param_dtype=torch.float32)
    enc.load_hf_state_dict(t5_state_dict_from_jax(params, jcfg))
    got = enc(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, 20, 32)
    assert _rel(got.float(), np.asarray(want, np.float32)) <= tol


def test_t5_embedder_matches_jax():
    """Both embedders with the same toy tokenizer object and weights: the
    captions are cleaned, tokenized to 16 tokens (one truncated), encoded."""
    jcfg = JaxT5Config.small_test(num_layers=LAYERS)
    params = _jax_params(jcfg, seed=2)
    tok = WordHashTokenizer()
    texts = ["A <b>Photo</b> of a cat --ar 16:9 https://example.com",
             "a small cactus with a happy face",
             "one two three four five six seven eight nine ten eleven twelve thirteen "
             "fourteen fifteen sixteen seventeen"]
    y_j, m_j = JaxT5Embedder(params, jcfg, tok, model_max_length=16).get_text_embeddings(texts)
    enc = build_t5(T5Config.small_test(num_layers=LAYERS), device="cpu")
    enc.load_hf_state_dict(t5_state_dict_from_jax(params, jcfg))
    y, m = T5Embedder(enc, tok, model_max_length=16).get_text_embeddings(texts)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_j))
    assert m.numpy().sum(1).tolist()[2] == 16
    assert _rel(y, np.asarray(y_j)) <= 1e-5


def test_t5_state_dict_from_jax_inverts_hf_t5_to_flax():
    cfg = T5Config.small_test(num_layers=LAYERS)
    enc = build_t5(cfg, device="cpu")
    init_weights(enc, torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in enc.state_dict().items()}
    back = t5_state_dict_from_jax(hf_t5_to_flax(sd, JaxT5Config.small_test(num_layers=LAYERS)),
                                  cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def _hf_tiny():
    from transformers import T5Config as HFT5Config, T5EncoderModel

    hf_cfg = HFT5Config(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=LAYERS,
                        num_heads=4, feed_forward_proj="gated-gelu", dropout_rate=0.0,
                        is_encoder_decoder=False, use_cache=False, tie_word_embeddings=False)
    torch.manual_seed(0)
    return T5EncoderModel(hf_cfg).eval()


def test_t5_embedder_from_pretrained_reads_an_hf_checkpoint(tmp_path):
    """A toy HF tokenizer (tokenizer.json) and a tiny saved T5EncoderModel:
    the port's module names load the checkpoint as it is, and the hidden
    states of the valid tokens agree with HF's."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    for w in "a photo of the cat small cactus with happy face".split():
        vocab.setdefault(w, len(vocab))
    for i in range(len(vocab), 128):
        vocab[f"tok{i}"] = i
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(single="$A </s>",
                                                       special_tokens=[("</s>", 1)])
    tok.save(str(tmp_path / "tokenizer.json"))
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>",
        "eos_token": "</s>", "unk_token": "<unk>", "model_max_length": 512}))
    model = _hf_tiny()
    model.save_pretrained(tmp_path, safe_serialization=True)

    emb = T5Embedder.from_pretrained(str(tmp_path), model_max_length=16, dtype=torch.float32,
                                     config=T5Config.small_test(num_layers=LAYERS), device="cpu")
    texts = ["A photo of a cat", "a small cactus with a happy face"]
    y, mask = emb.get_text_embeddings(texts)
    assert y.shape == (2, 16, 32) and mask.shape == (2, 16)
    enc = emb.tokenizer([t.lower() for t in texts], max_length=16, padding="max_length",
                        truncation=True, return_tensors="np")
    assert not (enc["input_ids"] == vocab["<unk>"]).any()
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(enc["input_ids"]),
                     attention_mask=torch.from_numpy(enc["attention_mask"])).last_hidden_state
    valid = mask.bool()
    np.testing.assert_allclose(y[valid].numpy(), want[valid].numpy(), rtol=2e-4, atol=2e-5)


def test_from_pretrained_without_weights_raises(tmp_path):
    (tmp_path / "tokenizer_config.json").write_text("{}")
    from pixart_sigma_tpu_torch.models.t5 import _load_hf_state_dict

    with pytest.raises(FileNotFoundError, match="no \\*.safetensors"):
        _load_hf_state_dict(str(tmp_path))
