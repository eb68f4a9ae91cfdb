"""The port's mesh (``thunder_tpu_torch.parallel``) against the JAX package, on the CPU.

The multi-rank cases run in 2 or 4 processes of ``tests/torch_parallel_worker.py``, joined in a gloo group
through a ``FileStore`` under ``tmp_path`` (no TCP port: the suite runs under xdist). Two module-scoped
launches carry every case: a world of 2 (the dp2 mesh) and a world of 4 (dp4, and dp2 x tp2 with
``model_parallel=2``). The inputs are ``tests/distributed_worker.py``'s shapes (8 rows of 4,000 samples,
"hello world" targets) made with numpy from a seed; the weights are the JAX modules' through ``bridge.py``.

Held against the JAX package:

- the mesh's shapes and its refusals; ``param_shardings`` key for key (QuartzNet with 256 filters, Citrinet
  with squeeze-excite, wav2vec2 at hidden 256); ``_pad_batch_for_mesh``;
- one SGD step (lr 1e-3) of QuartzNet, Citrinet (the masked squeeze-excite) and wav2vec2 in train mode on
  dp2, dp4 and dp2 x tp2 against the JAX single-device step: the loss at rel 1e-4 and every parameter and
  running statistic at atol 1e-3, the JAX mesh test's tolerances; and, since such a step moves a weight by
  about 1e-3, against the port's meshless step at rel 1e-6 and atol 1e-6 (measured: 6e-8);
- the eval forward sharded over dp2 x tp2 against the JAX forward (atol 2e-4; wav2vec2 2e-5, with its
  extractor convs sharded too at ``min_channels=64``);
- ``beam_search_device(mesh=...)`` against the JAX ``beam_search_device(mesh=...)`` (``_sharded_beam_fn``) on
  the same logits, and its refusal of a batch that does not divide the axis.

Held against the port's own meshless path:

- a padded 3-row batch on dp4 against the unpadded step (loss rel 1e-5, parameters atol 1e-5, the JAX
  padding test's);
- a step with dropout 0.1 (and dither) on dp2: every dropout mask is the single-process mask's rows bit for
  bit, and the step equals the single-process step (loss rel 1e-5; parameters atol 1e-4: the global sums
  differ in order, and a pre-activation at zero may take the other side of a ReLU); also wav2vec2 in
  bfloat16, where the plain versions of the training kernels take the rows' offset;
- the engine's data-parallel ``predict`` (greedy, device beam at W = 6, host beam), ``__call__``,
  ``predict_long`` and ``warmup`` on 8 and 3 rows against the meshless engine;
- a mesh checkpoint restored meshless and a whole state loaded onto the mesh and gathered back, bit-equal;
- the global-norm clip under tp2 against the meshless clip; ``validate``'s metrics; ``remat`` and gradient
  accumulation on the mesh.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_worker as W
from thunder_tpu.audio import FilterbankFeatures as JaxFilterbank
from thunder_tpu.audio import Wav2Vec2Preprocess as JaxPreprocess
from thunder_tpu.models import CitrinetEncoder as JaxCitrinet
from thunder_tpu.models import Conv1dDecoder as JaxDecoder
from thunder_tpu.models import LinearDecoder as JaxLinearDecoder
from thunder_tpu.models import QuartznetEncoder as JaxQuartznet
from thunder_tpu.models import wav2vec2 as jax_w2v
from thunder_tpu.module import CTCModule as JaxModule
from thunder_tpu.ops.ctc_beam_device import beam_search_device as jax_beam_search_device
from thunder_tpu.parallel import make_mesh as jax_make_mesh
from thunder_tpu.parallel import param_shardings as jax_param_shardings
from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu.training.trainer import TrainState, make_train_step
from thunder_tpu.training.trainer import _pad_batch_for_mesh as jax_pad_batch_for_mesh
from thunder_tpu_torch.bridge import from_flax_variables, state_key
from thunder_tpu_torch.parallel import make_mesh
from thunder_tpu_torch.training.trainer import _pad_batch_for_mesh

WORKER = Path(__file__).with_name("torch_parallel_worker.py")
ROOT = Path(__file__).resolve().parents[1]
MODELS = ("qn256", "citrinet", "w2v")
MESHES = {"dp2": (2, 1), "dp4": (4, 1), "dp2xtp2": (4, 2)}


def _jax_module(kind: str):
    tt = JaxText(tokens=W.TOKENS)
    if kind == "qn256":
        parts = dict(audio_transform=JaxFilterbank(dither=0.0), encoder=JaxQuartznet(**W.QN256),
                     decoder=JaxDecoder(num_classes=tt.num_tokens))
    elif kind == "citrinet":
        parts = dict(audio_transform=JaxFilterbank(nfilt=80, dither=0.0), encoder=JaxCitrinet(**W.CITRINET),
                     decoder=JaxDecoder(num_classes=tt.num_tokens))
    else:
        parts = dict(audio_transform=JaxPreprocess(mask_input=True),
                     encoder=jax_w2v.Wav2Vec2Encoder(jax_w2v.Wav2Vec2Config(**W.W2V), mask_input=True),
                     decoder=JaxLinearDecoder(num_classes=tt.num_tokens))
    return JaxModule.create(jax.random.PRNGKey(0), text_transform=tt, sample_len=4000, **parts)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_inputs(kind: str):
    """The JAX module, its state through the bridge, and the batch."""
    module = _jax_module(kind)
    state = {k: torch.as_tensor(v) for k, v in from_flax_variables(_numpy(module.variables)).items()}
    return {"module": module, "state": state, "batch": W.batch(W.build(kind))}


def _jax_reference(ref: dict) -> None:
    """Add the JAX single-device SGD step and eval forward to ``ref`` (from :func:`_jax_inputs`)."""
    module, batch = ref["module"], ref["batch"]
    variables = _numpy(module.variables)
    state = TrainState.create(apply_fn=module.model.apply,
                              params=jax.tree_util.tree_map(jnp.array, variables["params"]),
                              tx=optax.sgd(learning_rate=1e-3),
                              batch_stats=jax.tree_util.tree_map(jnp.array, variables.get("batch_stats")))
    state, loss = make_train_step(module.model, module.blank_idx)(state, *(jnp.asarray(b) for b in batch),
                                                                   jax.random.PRNGKey(42))
    stepped = {"params": state.params}
    if state.batch_stats is not None:
        stepped["batch_stats"] = state.batch_stats
    logits, lengths = module.forward(batch[0], batch[1])
    ref.update(loss=float(loss), stepped=from_flax_variables(_numpy(stepped)), logits=np.asarray(logits),
               lengths=np.asarray(lengths))


def _spawn(directory: Path, world: int, cases: list):
    """Start ``cases`` on a gloo world of ``world`` worker processes; the returned function waits for them and
    gives ``{case name: [result of each rank]}``."""
    directory.mkdir(parents=True, exist_ok=True)
    job = directory / "job.pt"
    torch.save(cases, job)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(rank), str(world), str(directory), str(job),
                               str(directory)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for rank in range(world)]

    def results():
        outs = [p.communicate(timeout=600)[0].decode() for p in procs]
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-4000:]
        return {c["name"]: [torch.load(directory / f"{c['name']}.rank{r}.pt", weights_only=False)
                            for r in range(world)] for c in cases}

    return results


def _beam_logits():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((8, 30, len(W.TOKENS) + 1)) * 3.0).astype(np.float32)
    lengths = np.array([30, 25, 30, 12, 30, 1, 29, 30], np.int32)
    return logits, lengths


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """``(refs, runs)``: the JAX references of each model, and every multi-rank case's results (the world of 2,
    dp2, and the world of 4, dp4 and dp2 x tp2), the JAX steps running while the workers do."""
    refs = {kind: _jax_inputs(kind) for kind in MODELS}

    def train(name, kind, mp, **kw):
        return dict(name=name, kind="train", model=kind, state=refs[kind]["state"], batch=refs[kind]["batch"],
                    model_parallel=mp, **kw)

    two = [train(f"train-{k}-dp2", k, 1) for k in MODELS]
    two += [
        train("dropout-qn256", "qn256", 1, dropout=0.1, masks=True),
        train("dropout-w2v-bf16", "w2v", 1, dropout=0.1, dtype=torch.bfloat16),
        train("remat-accumulate", "qn256", 1, remat=True, accumulate=2),
        dict(name="engine-dp2", kind="engine", model="qn256", state=refs["qn256"]["state"],
             batch=refs["qn256"]["batch"]),
    ]
    four = [dict(name="refusals", kind="refusals"), dict(name="shardings", kind="shardings", model_parallel=2)]
    four += [train(f"train-{k}-{m}", k, MESHES[m][1]) for k in MODELS for m in ("dp4", "dp2xtp2")]
    four += [
        train("padded-3-rows", "qn256", 1, rows=3),
        *[dict(name=f"forward-{k}", kind="forward", model=k, state=refs[k]["state"], batch=refs[k]["batch"],
               model_parallel=2, min_channels=64 if k == "w2v" else 256) for k in MODELS],
        dict(name="engine-dp2xtp2", kind="engine", model="qn256", state=refs["qn256"]["state"],
             batch=refs["qn256"]["batch"], model_parallel=2),
        dict(name="beam", kind="beam", logits=_beam_logits()[0], lengths=_beam_logits()[1]),
        dict(name="clip", kind="clip", model_parallel=2, max_norm=1.0,
             grads=[np.random.default_rng(i).standard_normal(s).astype(np.float32)
                    for i, s in enumerate([(3, 8, 256), (256,), (7,), (64, 512)])]),
        dict(name="checkpoint", kind="checkpoint", model="qn256", state=refs["qn256"]["state"],
             batch=refs["qn256"]["batch"], model_parallel=2),
        dict(name="validate", kind="validate", model="qn256", state=refs["qn256"]["state"],
             batch=refs["qn256"]["batch"], model_parallel=2),
    ]
    for case in two + four:
        case["rows"] = case.get("rows", 8)
    root = tmp_path_factory.mktemp("mesh")
    pending = [_spawn(root / "two", 2, two), _spawn(root / "four", 4, four)]
    for ref in refs.values():
        _jax_reference(ref)
    return refs, {name: out for wait in pending for name, out in wait().items()}


@pytest.fixture(scope="module")
def refs(results):
    return results[0]


@pytest.fixture(scope="module")
def runs(results):
    return results[1]


def _single_step(kind, state, batch, rows=8, **kw):
    torch.set_num_threads(1)
    module = W.build(kind, state, dropout=kw.pop("dropout", 0.0), dtype=kw.pop("dtype", torch.float32),
                     remat=kw.pop("remat", False))
    loss, stepped = W.sgd_step(module, tuple(x[:rows] for x in batch), **kw)
    return loss.item(), stepped


def test_mesh_shapes_and_refusals(runs):
    x = torch.arange(24).reshape(8, 3)
    for rank, out in enumerate(runs["refusals"]):
        assert out["mesh_shape"] == {"data": 2, "model": 2}
        data, model = out["coordinates"]
        assert (data, model) == (rank // 2, rank % 2)  # model the fast axis, as the JAX reshape(n // m, m)
        assert torch.equal(out["rows"], x[4 * data: 4 * data + 4])  # P("data")
        assert torch.equal(out["stacked_rows"], x.reshape(2, 4, 3)[:, 2 * data: 2 * data + 2])  # P(None, "data")
        assert torch.equal(out["replicated"], x)
        assert out["refused_rows"] == "batch 5 must divide the mesh's 'data' axis (2)"
        assert out["refused_3"] == "4 devices not divisible by model_parallel=3"
        assert "model_parallel=0" in out["refused_0"]
        assert "nccl" in out["refused_backend"] and "gloo" in out["refused_backend"]
    with pytest.raises(ValueError, match="not divisible by model_parallel=3"):
        jax_make_mesh(model_parallel=3)  # the JAX refusal the port's mirrors (8 devices here)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="torch.distributed.init_process_group"):
        make_mesh()


@pytest.mark.parametrize("kind", MODELS)
def test_param_shardings_match_jax(runs, refs, kind):
    got = runs["shardings"][0][kind]
    jax_mesh = jax_make_mesh(model_parallel=2)
    variables = refs[kind]["module"].variables
    want = {}
    for collection in ("params", "batch_stats"):
        if collection not in variables:
            continue
        flat = jax.tree_util.tree_flatten_with_path(jax_param_shardings(variables[collection], jax_mesh))[0]
        for path, sharding in flat:
            want[state_key(collection, tuple(str(p.key) for p in path))] = tuple(sharding.spec)
    assert got == want
    assert any(spec for spec in got.values())  # the rule shards something in each model


def test_pad_batch_for_mesh_matches_jax(refs):
    batch = refs["qn256"]["batch"]
    for data in (4, 8):
        mesh = types.SimpleNamespace(shape={"data": data, "model": 1})
        for rows in (3, 5, 8):
            part = tuple(np.asarray(b)[:rows] for b in batch)
            got, got_w = _pad_batch_for_mesh(part, mesh)
            want, want_w = jax_pad_batch_for_mesh(part, mesh)
            np.testing.assert_array_equal(got_w, want_w)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def single_steps(refs):
    """The port's meshless SGD step of each model."""
    return {kind: _single_step(kind, refs[kind]["state"], refs[kind]["batch"]) for kind in MODELS}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", MODELS)
def test_sgd_step_matches_jax(runs, refs, single_steps, kind, mesh):
    ref = refs[kind]
    single_loss, single = single_steps[kind]
    for out in runs[f"train-{kind}-{mesh}"]:
        assert out["loss"] == pytest.approx(ref["loss"], rel=1e-4)
        assert set(out["state"]) == set(ref["stepped"])
        for key, want in ref["stepped"].items():
            np.testing.assert_allclose(out["state"][key].numpy(), want.numpy(), atol=1e-3, err_msg=key)
        # the update itself, against the port's meshless step: an SGD step at lr 1e-3 moves a weight by about
        # 1e-3, inside the JAX tolerance, so a wrong gradient shows only here
        assert out["loss"] == pytest.approx(single_loss, rel=1e-6)
        for key, want in single.items():
            np.testing.assert_allclose(out["state"][key].numpy(), want.numpy(), atol=1e-6, err_msg=key)


def test_padded_batch_loss_matches_unpadded(runs, refs):
    ref = refs["qn256"]
    loss, stepped = _single_step("qn256", ref["state"], ref["batch"], rows=3)
    for out in runs["padded-3-rows"]:
        assert out["loss"] == pytest.approx(loss, rel=1e-5)
        for key, want in stepped.items():
            np.testing.assert_allclose(out["state"][key].numpy(), want.numpy(), atol=1e-5, err_msg=key)


@pytest.mark.parametrize("case", ["dropout-qn256", "dropout-w2v-bf16"])
def test_dropout_step_matches_single_process(runs, refs, case):
    kind = case.split("-")[1]
    dtype = torch.bfloat16 if case.endswith("bf16") else torch.float32
    from thunder_tpu_torch.models import layers

    masks, apply = [], layers.apply_dropout
    layers.apply_dropout = lambda x, keep, rate: (masks.append(keep.clone()), apply(x, keep, rate))[1]
    try:
        loss, stepped = _single_step(kind, refs[kind]["state"], refs[kind]["batch"], dropout=0.1, dtype=dtype)
    finally:
        layers.apply_dropout = apply
    outs = runs[case]
    if "masks" in outs[0]:
        assert len(masks) == len(outs[0]["masks"]) > 0
        for rank, out in enumerate(outs):
            for whole, part in zip(masks, out["masks"]):
                assert torch.equal(whole[4 * rank: 4 * rank + 4], part)
    rel, atol = (1e-5, 1e-4) if dtype == torch.float32 else (1e-3, 1e-3)
    for out in outs:
        assert out["loss"] == pytest.approx(loss, rel=rel)
        for key, want in stepped.items():
            np.testing.assert_allclose(out["state"][key].float().numpy(), want.float().numpy(), atol=atol,
                                       err_msg=key)


def test_remat_and_accumulation_on_mesh(runs, refs):
    ref = refs["qn256"]
    loss, stepped = _single_step("qn256", ref["state"], ref["batch"], remat=True, accumulate=2)
    for out in runs["remat-accumulate"]:
        assert out["loss"] == pytest.approx(loss, rel=1e-5)
        for key, want in stepped.items():
            np.testing.assert_allclose(out["state"][key].numpy(), want.numpy(), atol=1e-5, err_msg=key)


@pytest.mark.parametrize("kind", MODELS)
def test_sharded_inference_matches_jax(runs, refs, kind):
    ref = refs[kind]
    atol = 2e-5 if kind == "w2v" else 2e-4
    outs = runs[f"forward-{kind}"]
    for out in outs:
        np.testing.assert_array_equal(out["lengths"].numpy(), ref["lengths"])
        np.testing.assert_allclose(out["logits"].numpy(), ref["logits"], atol=atol)
    sharded = outs[0]["sharded"]
    assert sharded
    if kind == "w2v":
        assert "encoder.layer0.attention.qkv_proj.kernel" in sharded
        assert "encoder.feature_extractor.conv0.kernel" in sharded and "encoder.pos_conv.kernel" in sharded
    if kind == "citrinet":
        assert "encoder.block0.se.fc2.kernel" in sharded and "encoder.block0.rep0.bn.mean" in sharded


@pytest.mark.parametrize("mesh", ["dp2", "dp2xtp2"])
def test_engine_data_parallel_predict(runs, mesh):
    for out in runs[f"engine-{mesh}"]:
        assert out["warmup"] == 1
        for rows in (8, 3):
            for mode in ("greedy", "device", "host", "long"):
                sharded, single = out[rows][mode]
                assert sharded == single, (rows, mode)
            sharded, single = out[rows]["logits"]
            assert sharded.shape[0] == rows
            np.testing.assert_allclose(sharded.numpy(), single.numpy(), atol=1e-5)


def test_sharded_device_beam_matches_jax(runs):
    logits, lengths = _beam_logits()
    want = jax_beam_search_device(jnp.asarray(logits), lengths, blank=0, beam_width=6, nbest=2,
                                  mesh=jax_make_mesh(model_parallel=1), use_pallas=False)
    for out in runs["beam"]:
        assert len(out["hyps"]) == len(want) == 8
        for got_row, want_row in zip(out["hyps"], want):
            assert [ids.tolist() for ids, _ in got_row] == [ids.tolist() for ids, _ in want_row]
            np.testing.assert_allclose([s for _, s in got_row], [s for _, s in want_row], rtol=1e-5)
        assert out["refused"] == ("batch 6 must divide the mesh's 'data' axis (4) for sharded beam decoding "
                                  "(pad the batch like the engine does)")


def test_checkpoint_mesh_to_meshless_and_back(runs):
    for out in runs["checkpoint"]:
        payload = out["payload"]
        assert payload["step"] == 2
        for key, value in out["fitted"].items():
            assert torch.equal(payload["model"][key], value), key
            assert torch.equal(out["meshless_model"][key], value), key
        roundtrip = out["roundtrip"]
        for key, value in payload["model"].items():
            assert torch.equal(roundtrip["model"][key], value), key
        for name, state in payload["optimizer"]["state"].items():
            for k, v in state.items():
                assert torch.equal(roundtrip["optimizer"]["state"][name][k], v), (name, k)
        assert any(state["exp_avg"].shape[-1] == 256 for state in payload["optimizer"]["state"].values())


def test_global_norm_clip_under_tp_matches_meshless(runs):
    from thunder_tpu_torch.training.optim import clip_by_global_norm_

    grads = [np.random.default_rng(i).standard_normal(s).astype(np.float32)
             for i, s in enumerate([(3, 8, 256), (256,), (7,), (64, 512)])]
    want = [torch.as_tensor(g) for g in grads]
    clip_by_global_norm_(want, 1.0)
    for out in runs["clip"]:
        for got, w in zip(out["clipped"], want):
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-6, atol=1e-9)


def test_validate_on_mesh_matches_meshless(runs):
    for out in runs["validate"]:
        mesh, single = out["mesh"], out["single"]
        assert mesh["metrics/cer"] == single["metrics/cer"] and mesh["metrics/wer"] == single["metrics/wer"]
        assert mesh["loss/val_loss"] == pytest.approx(single["loss/val_loss"], rel=1e-5)
