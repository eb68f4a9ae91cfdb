"""One rank of the port's multi-process mesh tests (``tests/test_torch_parallel.py``).

Run as ``python tests/torch_parallel_worker.py <rank> <world> <store_dir> <job.pt> <out_dir>``: the process
joins a gloo process group through a ``FileStore`` under ``store_dir`` (no TCP port, so parallel test
workers cannot collide), runs every case of the job on one CPU thread, and saves each case's result as
``<out_dir>/<case>.rank<rank>.pt``. It imports no JAX; the test holds the results against the JAX
package. The model factories below are shared with the test, so both sides make the same port modules.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

TOKENS = list("abcdefghijklmnopqrstuvwxyz '")
QN256 = dict(repeat=1, filters=(256,), kernel_sizes=(33,))
CITRINET = dict(filters=(64,), kernel_sizes=(11,), strides=(2,), repeat=2)
W2V = dict(hidden_size=256, num_hidden_layers=2, num_attention_heads=4, intermediate_size=512, conv_dim=(64,) * 7,
           hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0)


def build(kind: str, state=None, dropout: float = 0.0, dtype=torch.float32, remat: bool = False):
    """A port CTCModule on the CPU: ``qn256`` (QuartzNet, 256 filters), ``citrinet`` (with squeeze-excite) or
    ``w2v`` (wav2vec2, hidden 256), with ``state`` loaded when given."""
    from thunder_tpu_torch.audio import FilterbankFeatures, Wav2Vec2Preprocess
    from thunder_tpu_torch.models import CitrinetEncoder, Conv1dDecoder, LinearDecoder, QuartznetEncoder
    from thunder_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    dither = 1e-5 if dropout else 0.0
    if kind == "qn256":
        parts = (FilterbankFeatures(dither=dither), QuartznetEncoder(**QN256, dropout=dropout, remat=remat),
                 Conv1dDecoder(len(TOKENS) + 1))
    elif kind == "citrinet":
        parts = (FilterbankFeatures(nfilt=80, dither=dither), CitrinetEncoder(**CITRINET, dropout=dropout, remat=remat),
                 Conv1dDecoder(len(TOKENS) + 1))
    else:
        config = {**W2V, **({"hidden_dropout": dropout, "attention_dropout": dropout} if dropout else {})}
        parts = (Wav2Vec2Preprocess(mask_input=True), Wav2Vec2Encoder(Wav2Vec2Config(**config), dtype=dtype,
                                                                       remat=remat),
                 LinearDecoder(len(TOKENS) + 1, dtype=dtype))
    module = CTCModule.create(torch.Generator().manual_seed(0), *parts, BatchTextTransformer(TOKENS), device="cpu")
    if state is not None:
        module.model.load_state_dict(state)
    return module


def batch(module, rows: int = 8, samples: int = 4000, seed: int = 0):
    """``tests/distributed_worker.py``'s ``make_batch``: ``(audio, lengths, targets, target_lengths)``, numpy."""
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((rows, samples)) * 0.3).astype(np.float32)
    lengths = np.full((rows,), samples, dtype=np.int32)
    targets, target_lengths = module.text_transform.encode(["hello world"] * rows, pad_to=16)
    return audio, lengths, targets, target_lengths


def sgd_step(module, data, mesh=None, generator_seed=None, accumulate: int = 1, clip=None):
    """One SGD step (lr 1e-3) of ``module`` (sharded in place on a ``mesh``) on the global batch ``data``:
    ``(loss, whole state after the step)``. With ``accumulate`` the batch is fed that many times."""
    from thunder_tpu_torch.parallel import full_state, shard_variables
    from thunder_tpu_torch.training.optim import sgd
    from thunder_tpu_torch.training.trainer import TrainStep, _pad_batch_for_mesh

    weights = None
    if mesh is not None:
        shard_variables(module.model, mesh)
        data, weights = _pad_batch_for_mesh(data, mesh)
    step = TrainStep(module.model, sgd(module.model.parameters(), learning_rate=1e-3), module.blank_idx,
                     accumulate_grad_batches=accumulate, gradient_clip_norm=clip, mesh=mesh)
    generator = torch.Generator().manual_seed(generator_seed if generator_seed is not None else 0)
    tensors = [torch.as_tensor(np.asarray(x)) for x in data]
    for _ in range(accumulate):
        loss = step(*tensors, generator, sample_weights=weights)
    return loss, {k: v.clone() for k, v in full_state(module.model).items()}


def _case(case: dict, rank: int, world: int, out_dir: Path):
    import torch.distributed as dist

    from thunder_tpu_torch.parallel import make_mesh, param_shardings
    from thunder_tpu_torch.parallel import spmd

    kind = case["kind"]
    mesh = make_mesh(model_parallel=case.get("model_parallel", 1), device="cpu") if kind != "refusals" else None
    out = {}
    if kind == "refusals":
        from thunder_tpu_torch.parallel import batch_sharding, replicated, stacked_batch_sharding

        grid = make_mesh(model_parallel=2, device="cpu")
        out["mesh_shape"] = grid.shape
        out["coordinates"] = (grid.data_rank, grid.model_rank)
        x = torch.arange(24).reshape(8, 3)
        out["rows"] = batch_sharding(grid)(x)
        out["stacked_rows"] = stacked_batch_sharding(grid)(x.reshape(2, 4, 3))
        out["replicated"] = replicated(grid)(x)
        try:
            batch_sharding(grid)(x[:5])
        except ValueError as e:
            out["refused_rows"] = str(e)
        for mp in (3, 0):
            try:
                make_mesh(model_parallel=mp, device="cpu")
            except ValueError as e:
                out[f"refused_{mp}"] = str(e)
        try:
            make_mesh(device="cuda")
        except ValueError as e:
            out["refused_backend"] = str(e)
    elif kind == "shardings":
        for name in ("qn256", "citrinet", "w2v"):
            out[name] = param_shardings(build(name).model, mesh)
    elif kind == "train":
        from thunder_tpu_torch.models import layers

        module = build(case["model"], case["state"], dropout=case.get("dropout", 0.0),
                       dtype=case.get("dtype", torch.float32), remat=case.get("remat", False))
        data = tuple(x[: case["rows"]] for x in case["batch"])
        masks, apply = [], layers.apply_dropout
        if case.get("masks"):  # record every dropout mask the step draws
            layers.apply_dropout = lambda x, keep, rate: (masks.append(keep.clone()), apply(x, keep, rate))[1]
        try:
            loss, state = sgd_step(module, data, mesh, accumulate=case.get("accumulate", 1))
        finally:
            layers.apply_dropout = apply
        out = {"loss": loss.item(), "state": state, **({"masks": masks} if case.get("masks") else {})}
    elif kind == "forward":
        from thunder_tpu_torch.parallel import batch_sharding, shard_variables

        module = build(case["model"], case["state"])
        shard_variables(module.model, mesh, min_channels=case.get("min_channels", 256))
        shard = batch_sharding(mesh)
        audio, lengths = (torch.as_tensor(x) for x in case["batch"][:2])
        with torch.no_grad():
            logits, out_lengths = module.model(shard(audio), shard(lengths))
        out = {"logits": spmd.all_gather_rows(logits, mesh.data_group),
               "lengths": spmd.all_gather_rows(out_lengths, mesh.data_group),
               "sharded": sorted(k for k, t in [*module.model.named_parameters(), *module.model.named_buffers()]
                                 if spmd.shard_of(t) is not None)}
    elif kind == "engine":
        from thunder_tpu_torch.engine import InferenceEngine

        module = build(case["model"], case["state"])
        audio, lengths = case["batch"][:2]
        single, sharded = InferenceEngine(module), InferenceEngine(module, mesh=mesh)
        for rows in (8, 3):
            a, n = audio[:rows], lengths[:rows]
            out[rows] = {
                "greedy": (sharded.predict(a, n), single.predict(a, n)),
                "device": (sharded.predict(a, n, beam_width=6, beam_backend="device"),
                           single.predict(a, n, beam_width=6, beam_backend="device")),
                "host": (sharded.predict(a, n, beam_width=6), single.predict(a, n, beam_width=6)),
                "logits": (sharded(a, n)[0], single(a, n)[0]),
                "long": (sharded.predict_long(a[0], chunk_seconds=0.125, overlap_seconds=0.025),
                         single.predict_long(a[0], chunk_seconds=0.125, overlap_seconds=0.025)),
            }
        out["warmup"] = sharded.warmup([3], [0.25])
    elif kind == "beam":
        from thunder_tpu_torch.ops.ctc_beam_device import beam_search_device

        logits, lengths = case["logits"], case["lengths"]
        out["hyps"] = beam_search_device(logits, lengths, beam_width=6, blank=0, nbest=2, mesh=mesh, device="cpu")
        try:
            beam_search_device(logits[:6], lengths[:6], beam_width=6, blank=0, mesh=mesh, device="cpu")
        except ValueError as e:
            out["refused"] = str(e)
    elif kind == "clip":
        from thunder_tpu_torch.parallel import gather_whole
        from thunder_tpu_torch.parallel.spmd import Shard, local_slice
        from thunder_tpu_torch.training.optim import clip_by_global_norm_

        grads = [torch.as_tensor(g) for g in case["grads"]]
        shard = Shard(mesh.model_group, mesh.model_rank, mesh.model_size)
        shards = [shard if g.shape[-1] % mesh.model_size == 0 and g.shape[-1] >= 256 else None for g in grads]
        local = [local_slice(g, s).clone() if s is not None else g.clone() for g, s in zip(grads, shards)]
        clip_by_global_norm_(local, case["max_norm"], shards)
        out["clipped"] = [gather_whole(g, s) if s is not None else g for g, s in zip(local, shards)]
    elif kind == "checkpoint":
        out = _checkpoint_case(case, mesh, out_dir)
    elif kind == "fit":
        from thunder_tpu_torch.training.trainer import Trainer

        trainer = Trainer(mesh=mesh, device="cpu", **case["trainer"])
        fitted = trainer.fit(build(case["model"], case["state"]), case["loader"])
        out = {"losses": [e["loss/train_loss"] for e in trainer.logs if "loss/train_loss" in e],
               "state": {k: v.clone() for k, v in fitted.model.state_dict().items()},
               "steps": (trainer.eager_steps, trainer.replayed_steps)}
    elif kind == "validate":
        from thunder_tpu_torch.training.trainer import Trainer

        module = build(case["model"], case["state"])
        audio, lengths = case["batch"][:2]
        loader = [(audio[:5], lengths[:5], ["hello world"] * 5), (audio[5:], lengths[5:], ["the cat"] * 3)]
        out = {"mesh": Trainer(mesh=mesh, device="cpu").validate(module, loader),
               "single": Trainer(device="cpu").validate(module, loader)}
    dist.barrier()
    torch.save(out, out_dir / f"{case['name']}.rank{rank}.pt")


def _checkpoint_case(case, mesh, out_dir: Path) -> dict:
    """A mesh ``fit`` with a checkpoint, that checkpoint loaded meshless, and a meshless state loaded on the
    mesh and gathered back."""
    from thunder_tpu_torch.parallel import shard_variables
    from thunder_tpu_torch.training.checkpointing import load_train_state, restore_checkpoint, train_state
    from thunder_tpu_torch.training.trainer import Trainer

    audio, lengths = case["batch"][:2]
    loader = [(audio[:5], lengths[:5], ["hello world"] * 5), (audio[5:], lengths[5:], ["the cat"] * 3)]
    ckpt = out_dir / "ckpt"
    trainer = Trainer(mesh=mesh, checkpoint_dir=str(ckpt), accumulate_grad_batches=1, device="cpu")
    fitted = trainer.fit(build(case["model"], case["state"]), loader)
    out = {"fitted": {k: v.clone() for k, v in fitted.model.state_dict().items()}}
    payload = restore_checkpoint(str(ckpt / "step_2"))
    # meshless: a train step built as the saved one, loading the mesh checkpoint
    plain = build(case["model"], case["state"])
    step, generator, _ = Trainer(device="cpu").train_step_for(plain, loader)
    load_train_state(payload, step, generator)
    out["meshless_model"] = {k: v.clone() for k, v in plain.model.state_dict().items()}
    # the reverse: a whole state into the mesh's slices, gathered back
    module = build(case["model"], case["state"])
    shard_variables(module.model, mesh)
    step, generator, _ = Trainer(mesh=mesh, device="cpu").train_step_for(module, loader, mesh)
    load_train_state(payload, step, generator)
    out["roundtrip"] = train_state(step, generator)
    out["payload"] = payload
    return out


def main(rank: int, world: int, store_dir: str, job: str, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(str(Path(store_dir) / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        for case in torch.load(job, weights_only=False):
            _case(case, rank, world, Path(out_dir))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
