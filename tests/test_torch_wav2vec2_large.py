"""wav2vec2-large-960h's widths in the port against the JAX package (CPU).

``facebook/wav2vec2-large-960h``'s published config: hidden 1024, 16 heads of 64, FFN 4096, a group-norm
extractor of seven 512-channel convs without biases, post-LN layers, a k=128 positional conv in 16 groups, 32
output classes. Depth is cut from 24 layers to 2 and the audio to 1 s (2 rows, lengths 16,000 and 11,000) so
that both packages run it on the CPU within the suite's time; every width is the published one. The JAX
module is initialised from a seed and its variables go through the bridge, at ``test_torch_wav2vec2.py``'s and
``test_torch_wav2vec2_training.py``'s tolerances:

- eval logits in float32 (the module's forward): identical lengths, within 1e-4 on valid frames;
- eval logits of the bfloat16 engines (the port's kernels through their plain versions here): identical
  lengths, within 0.05 of the largest magnitude;
- the train-mode CTC loss with every dropout rate 0: rtol 1e-5 in float32, 0.05 in bfloat16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.audio import Wav2Vec2Preprocess as JaxPreprocess
from thunder_tpu.engine import InferenceEngine as JaxEngine
from thunder_tpu.models import LinearDecoder as JaxLinearDecoder
from thunder_tpu.models import wav2vec2 as jax_w2v
from thunder_tpu.module import CTCModel as JaxModel
from thunder_tpu.module import CTCModule as JaxModule
from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu.training.trainer import _encode_targets as jax_encode_targets
from thunder_tpu_torch.audio import Wav2Vec2Preprocess
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.engine import InferenceEngine
from thunder_tpu_torch.models import LinearDecoder, Wav2Vec2Config, Wav2Vec2Encoder
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.text import BatchTextTransformer

torch.set_num_threads(2)

TOKENS = list("abcdefghijklmnopqrstuvwxyz '.,?")  # 31 characters and the blank: the checkpoint's 32 classes
LAYERS = 2  # the published 24, cut for the CPU
LARGE_960H = dict(hidden_size=1024, num_hidden_layers=LAYERS, num_attention_heads=16, intermediate_size=4096,
                  feat_extract_norm="group", do_stable_layer_norm=False, conv_bias=False,
                  hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0)
TEXTS = ["hello world", "the cat"]


def _audio():
    rng = np.random.default_rng(23)
    return (rng.standard_normal((2, 16000)) * 0.3).astype(np.float32), np.array([16000, 11000], np.int32)


def _port(variables, dtype=torch.float32) -> CTCModule:
    port = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=True),
                            Wav2Vec2Encoder(Wav2Vec2Config(**LARGE_960H), dtype=dtype),
                            LinearDecoder(len(TOKENS) + 1, dtype=dtype), BatchTextTransformer(TOKENS), device="cpu")
    port.model.load_state_dict(from_flax_variables(variables))
    return port


@pytest.fixture(scope="module")
def pair():
    tt = JaxText(tokens=TOKENS)
    jax_module = JaxModule.create(jax.random.PRNGKey(23), audio_transform=JaxPreprocess(mask_input=True),
                                  encoder=jax_w2v.Wav2Vec2Encoder(jax_w2v.Wav2Vec2Config(**LARGE_960H)),
                                  decoder=JaxLinearDecoder(num_classes=tt.num_tokens), text_transform=tt,
                                  sample_len=16000)
    variables = jax.tree_util.tree_map(np.asarray, jax_module.variables)
    assert variables["params"]["encoder"]["layer0"]["attention"]["qkv_proj"]["kernel"].shape == (1024, 3 * 1024)
    return jax_module, variables


def test_float32_logits_match_jax(pair):
    jax_module, variables = pair
    audio, lengths = _audio()
    want, want_lens = jax_module.forward(audio, lengths)
    got, got_lens = _port(variables).forward(audio, lengths)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.shape == (2, 49, len(TOKENS) + 1)
    for i, n in enumerate(np.asarray(want_lens)):
        np.testing.assert_allclose(got[i, :n].numpy(), np.asarray(want)[i, :n], atol=1e-4, rtol=0)


def test_bfloat16_engine_matches_jax_bfloat16_engine(pair):
    jax_module, variables = pair
    audio, lengths = _audio()
    want, want_lens = JaxEngine(jax_module, compute_dtype=jnp.bfloat16)(audio, lengths)
    got, got_lens = InferenceEngine(_port(variables), compute_dtype=torch.bfloat16)(audio, lengths)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    want = np.asarray(want, np.float32)
    assert np.isfinite(got.numpy()).all()
    for i, n in enumerate(np.asarray(want_lens)):
        dev = np.abs(got[i, :n].numpy() - want[i, :n]).max() / np.abs(want[i, :n]).max()
        assert dev < 0.05, (i, dev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_loss_without_dropout_matches_jax(pair, dtype):
    jax_module, variables = pair
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    audio, lengths = _audio()
    targets, target_lengths = jax_encode_targets(jax_module.text_transform, TEXTS)
    model = JaxModel(audio_transform=JaxPreprocess(mask_input=True),
                     encoder=jax_w2v.Wav2Vec2Encoder(jax_w2v.Wav2Vec2Config(**LARGE_960H), dtype=jdt),
                     decoder=JaxLinearDecoder(num_classes=len(TOKENS) + 1, dtype=jdt))
    jax_typed = dataclasses.replace(jax_module, model=model, _apply_cache={})  # the same variables, no new init
    args = (jnp.asarray(audio), jnp.asarray(lengths), jnp.asarray(targets), jnp.asarray(target_lengths))
    want, _ = jax_typed.loss(jax_typed.variables, *args, train=True, rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got, _ = _port(variables, tdt).loss(audio, lengths, targets, target_lengths, train=True,
                                            generator=torch.Generator().manual_seed(0))
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5 if dtype == "float32" else 0.05)
