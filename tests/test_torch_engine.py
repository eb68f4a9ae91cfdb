"""The whole slice against the JAX package: bridge, CTCModule and InferenceEngine (CPU, float32).

A small QuartzNet (stem, one body block of 2 repeats, tail, 1x1 block) with
randomized BN statistics is built in the JAX package, its variables go
through the bridge into the port, and both run the same numpy audio. Logits
are held at atol 2e-3 / rtol 1e-3 over valid frames (the engine-vs-module
bound of the JAX package's own tests); output lengths and transcripts must
be identical.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.audio import FilterbankFeatures as JaxFilterbank
from thunder_tpu.engine import InferenceEngine as JaxEngine
from thunder_tpu.models import Conv1dDecoder as JaxDecoder
from thunder_tpu.models import QuartznetEncoder as JaxQuartznet
from thunder_tpu.module import CTCModule as JaxModule
from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu_torch.audio import FilterbankFeatures
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.engine import InferenceEngine
from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.text import BatchTextTransformer

torch.set_num_threads(2)

TOKENS = list("abcdefghijklmnopqrstuvwxyz '")
SMALL = dict(repeat=2, filters=(256,), kernel_sizes=(33,))


def _randomized(module, seed=0):
    """Non-trivial BN statistics and affines, so that BN folding is tested."""
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(module.variables)
    for k, v in flat.items():
        if k[-1] == "var":
            flat[k] = jnp.asarray(rng.uniform(0.5, 2.0, v.shape).astype(np.float32))
        elif k[-1] == "mean" or (k[-1] in ("scale", "bias") and "bn" in k):
            flat[k] = jnp.asarray((rng.standard_normal(v.shape) * 0.3).astype(np.float32))
    return module.with_variables(flax.traverse_util.unflatten_dict(flat))


@pytest.fixture(scope="module")
def pair():
    tt = JaxText(tokens=TOKENS)
    jax_module = JaxModule.create(
        jax.random.PRNGKey(0),
        audio_transform=JaxFilterbank(),
        encoder=JaxQuartznet(**SMALL),
        decoder=JaxDecoder(num_classes=tt.num_tokens),
        text_transform=tt,
        sample_len=4000,
    )
    jax_module = _randomized(jax_module)
    port = CTCModule.create(
        torch.Generator().manual_seed(0),
        FilterbankFeatures(),
        QuartznetEncoder(**SMALL),
        Conv1dDecoder(len(TOKENS) + 1),
        BatchTextTransformer(TOKENS),
    )
    port.model.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, jax_module.variables)))
    return jax_module, port


def _audio(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 16000)) * 0.2).astype(np.float32), np.array([16000, 9000], np.int32)


def _assert_logits_close(got, got_lens, want, want_lens):
    np.testing.assert_array_equal(np.asarray(got_lens), np.asarray(want_lens))
    for i, n in enumerate(np.asarray(want_lens)):
        np.testing.assert_allclose(np.asarray(got)[i, :n], np.asarray(want)[i, :n], atol=2e-3, rtol=1e-3)


def test_bridge_round_trip(pair):
    """flax variables -> bridge -> the port's modules -> state_dict keeps every
    variable, bit for bit, under its flax path without the ``conv`` level that
    flax's ``nn.Conv`` adds above each kernel and bias."""
    jax_module, port = pair
    variables = jax.tree_util.tree_map(np.asarray, jax_module.variables)
    state = from_flax_variables(variables)
    module_state = port.model.state_dict()
    assert set(state) == set(module_state)
    flat_in = flax.traverse_util.flatten_dict(variables)
    assert len(flat_in) == len(module_state)
    for (collection, *path), value in flat_in.items():
        if collection == "params" and path[-2:-1] == ["conv"]:
            del path[-2]
        key = ".".join(path)
        np.testing.assert_array_equal(state[key].numpy(), value)
        np.testing.assert_array_equal(module_state[key].numpy(), value)
    # WIO layout kept: the depthwise kernel is (k, 1, C), the pointwise (1, C_in, C_out)
    assert tuple(port.model.encoder.block1.rep0.depthwise.kernel.shape) == (33, 1, 256)
    assert tuple(port.model.encoder.block1.rep0.pointwise.kernel.shape) == (1, 256, 256)


def test_module_forward_matches_jax(pair):
    jax_module, port = pair
    audio, lengths = _audio()
    want, want_lens = jax_module.forward(audio, lengths)
    got, got_lens = port.forward(audio, lengths)
    _assert_logits_close(got, got_lens, want, want_lens)


@pytest.mark.parametrize("seed", [0, 2])
def test_engine_matches_jax_engine(pair, seed):
    jax_module, port = pair
    audio, lengths = _audio(seed)
    want, want_lens = JaxEngine(jax_module, compute_dtype=jnp.float32, use_pallas=False)(audio, lengths)
    engine = InferenceEngine(port)
    assert engine.dtype == torch.float32
    got, got_lens = engine(audio, lengths)
    _assert_logits_close(got, got_lens, want, want_lens)
    # the engine keeps padding at exactly zero, so beyond-length logits are the decoder bias
    beyond = got[1, int(got_lens[1]) :].numpy()
    bias = port.model.decoder.bias.detach().numpy()
    np.testing.assert_allclose(beyond, np.broadcast_to(bias, beyond.shape), atol=1e-6)


def test_predict_matches_jax(pair):
    jax_module, port = pair
    audio = (np.random.default_rng(3).standard_normal(12000) * 0.2).astype(np.float32)
    jax_engine = JaxEngine(jax_module, compute_dtype=jnp.float32, use_pallas=False)
    want = jax_engine.predict(audio)
    assert want == jax_module.predict(audio)
    assert InferenceEngine(port).predict(audio) == want
    assert port.predict(audio) == want
    audio2, lengths2 = _audio(4)
    assert InferenceEngine(port).predict(audio2, lengths2) == jax_engine.predict(audio2, lengths2)


def test_engine_warmup_and_launch_free_cpu_path(pair):
    from thunder_tpu_torch.kernels import fused_log_mel, fused_separable_repeat

    _, port = pair
    before = (fused_log_mel.launches, fused_separable_repeat.launches)
    assert InferenceEngine(port).warmup([1, 2], [0.5]) == 2
    assert (fused_log_mel.launches, fused_separable_repeat.launches) == before


def test_engine_rejects_other_encoders_and_f32_on_cuda(pair, monkeypatch):
    _, port = pair

    class Other(torch.nn.Module):
        final_dimension = 8

        def forward(self, x, lengths, train=False):
            return x, lengths

    other = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(), Other(), Conv1dDecoder(3))
    with pytest.raises(NotImplementedError):
        InferenceEngine(other)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="bfloat16"):
        InferenceEngine(port, compute_dtype=torch.float32, device="cuda")


def test_batch_norm_and_its_fold_match_jax():
    from thunder_tpu.models.layers import TorchBatchNorm as JaxBatchNorm
    from thunder_tpu_torch.engine import _fold_bn
    from thunder_tpu_torch.models.layers import TorchBatchNorm

    rng = np.random.default_rng(8)
    c = 16
    stats = {"mean": rng.standard_normal(c), "var": rng.uniform(0.005, 0.05, c)}  # small var: eps 1e-3 matters
    params = {"scale": rng.standard_normal(c), "bias": rng.standard_normal(c)}
    stats, params = ({k: v.astype(np.float32) for k, v in d.items()} for d in (stats, params))
    x = rng.standard_normal((2, 5, c)).astype(np.float32)
    want = JaxBatchNorm().apply({"params": params, "batch_stats": stats}, jnp.asarray(x), use_running_average=True)
    bn = TorchBatchNorm(c)
    bn.load_state_dict({k: torch.as_tensor(v) for k, v in {**params, **stats}.items()})
    np.testing.assert_allclose(bn(torch.as_tensor(x)).detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    scale, bias = _fold_bn(bn)
    np.testing.assert_allclose(x * scale + bias, np.asarray(want), rtol=1e-5, atol=1e-5)
