"""Module and train-state checkpoints, and checkpoint tree migrations.

Port of ``thunder_tpu/training/checkpointing.py``:

- ``save_module`` / ``restore_module_variables`` keep a module's weights (its
  model's ``state_dict``: parameters and batch-norm running statistics) with
  ``torch.save`` / ``torch.load(weights_only=True)``, where the JAX package
  keeps its variables with Orbax;
- ``save_checkpoint`` / ``restore_checkpoint`` keep the train state in a
  ``step_N`` folder: everything the next step depends on (:func:`train_state`:
  the model's ``state_dict``, the optimizer's state by parameter name, the
  optimizer step, which also places the schedule and the fine-tuning freeze,
  the plateau state, ``TrainStep``'s count of micro-batches and the gradients
  it has accumulated since its last update, and the training generator's
  state). The JAX trainer derives each step's randomness from the step, so a
  resumed run replays the uninterrupted one; the port draws every dither,
  mask, dropout and kernel seed from one generator, so it saves that
  generator's state. A model whose tensors are channel-sharded over a mesh's
  model axis (``parallel.shard_variables``) saves the whole tensors (its
  weights, the optimizer state of its sharded parameters and their pending
  gradients, gathered over the model group) and loads a whole state into its
  slices, so a state moves between meshes and the meshless trainer;
- ``migrate_fused_qkv`` is pure numpy on nested dicts, lists, tuples and
  namedtuples, so a parameter or optimizer-moment tree saved by either
  package goes through it; a restore whose parameter names do not fit goes
  through it, as the JAX restore does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from thunder_tpu_torch.parallel.mesh import full_state, gather_whole
from thunder_tpu_torch.parallel.spmd import local_slice, shard_of

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "train_state",
    "load_train_state",
    "migrate_fused_qkv",
    "save_module",
    "restore_module_variables",
]

#: the weights' file name inside a checkpoint folder
MODULE_FILE = "module.pt"
#: the train state's file name inside a ``step_N`` folder
TRAIN_STATE_FILE = "train_state.pt"


def save_module(directory: str, module) -> str:
    """Save a CTCModule's weights (an inference checkpoint) as ``directory/module.pt``; returns its path."""
    path = Path(directory).absolute() / MODULE_FILE
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in module.model.state_dict().items()}, path)
    return str(path)


def restore_module_variables(path: str, module):
    """A copy of ``module`` holding the weights saved at ``path`` (strict: the same keys and shapes)."""
    return module.with_state(torch.load(path, map_location="cpu", weights_only=True))


def migrate_fused_qkv(tree):
    """Fuse wav2vec2 attention trees with separate q/k/v projections into the
    ``qkv_proj`` layout. Returns ``(tree, changed)``.

    Applies to any nested dict level holding all three ``{q,k,v}_proj``
    subtrees, params and optimizer-moment trees alike (Adam's moments mirror
    the parameter structure, so their kernels concatenate identically).
    """
    changed = False

    def walk(d):
        nonlocal changed
        if hasattr(d, "_fields"):  # namedtuple (optimizer states)
            return type(d)(*(walk(v) for v in d))
        if isinstance(d, (list, tuple)):
            seq = [walk(v) for v in d]
            return seq if isinstance(d, list) else tuple(seq)
        if not isinstance(d, dict):
            return d
        out = {k: walk(v) for k, v in d.items()}
        if {"q_proj", "k_proj", "v_proj"} <= set(out) and "qkv_proj" not in out:
            q, k, v = out.pop("q_proj"), out.pop("k_proj"), out.pop("v_proj")
            out["qkv_proj"] = {
                name: np.concatenate([np.asarray(q[name]), np.asarray(k[name]), np.asarray(v[name])], axis=-1)
                for name in q
                if name in k and name in v
            }
            changed = True
        return out

    return walk(tree), changed


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu(v) for v in tree]
    return tree


def _optimizer_params(optimizer) -> list:
    return [p for group in optimizer.param_groups for p in group["params"]]


def _parameter_names(model, optimizer) -> list:
    """The name of each of the optimizer's parameters, in its state_dict's index order."""
    name_of = {id(p): n for n, p in model.named_parameters()}
    return [name_of[id(p)] for p in _optimizer_params(optimizer)]


def _whole(t, param):
    """A tensor shaped like a sharded ``param`` (its optimizer state, its gradient) gathered to the whole one."""
    shard = shard_of(param)
    if shard is None or not isinstance(t, torch.Tensor) or t.shape != param.shape:
        return t
    return gather_whole(t, shard)


def _local(t, param):
    """This rank's slice of a whole tensor for a sharded ``param`` (any other tensor is kept)."""
    shard = shard_of(param)
    if shard is None or not isinstance(t, torch.Tensor) or t.ndim == 0 or t.shape[-1] != param.shape[-1] * shard.size:
        return t
    return local_slice(t.to(param.device), shard).clone()


def train_state(train_step, generator: torch.Generator) -> dict:
    """The train state of a ``TrainStep`` and the training generator, on the host (see the module docstring).
    With sharded tensors every rank of the model group must call it."""
    model, optimizer = train_step.model, train_step.optimizer
    names = _parameter_names(model, optimizer)
    params = dict(model.named_parameters())
    opt = optimizer.state_dict()
    plateau = getattr(optimizer, "plateau_state", None)
    pending = train_step.calls % train_step.accumulate != 0
    return _cpu({
        "model": full_state(model),
        "optimizer": {
            "state": {names[i]: {k: _whole(v, params[names[i]]) for k, v in s.items()}
                      for i, s in opt["state"].items()},
            "param_groups": [{**g, "params": [names[i] for i in g["params"]]} for g in opt["param_groups"]],
        },
        "step": int(train_step.steps),
        "calls": int(train_step.calls),
        "plateau": None if plateau is None else {k: v.item() if isinstance(v, np.generic) else v
                                                 for k, v in plateau._asdict().items()},
        "generator": generator.get_state(),
        "grads": {n: _whole(p.grad, p) for n, p in model.named_parameters() if pending and p.grad is not None},
    })


def load_train_state(payload: dict, train_step, generator: torch.Generator) -> None:
    """Put a train state (from :func:`train_state` or :func:`restore_checkpoint`) into a ``TrainStep`` built
    as the saved one was and into the training generator; a sharded model takes its slices of the whole
    tensors."""
    from thunder_tpu_torch.training.optim import PlateauState

    model, optimizer = train_step.model, train_step.optimizer
    tensors = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    model.load_state_dict({k: _local(v, tensors.get(k)) for k, v in payload["model"].items()})
    names = _parameter_names(model, optimizer)
    index = {n: i for i, n in enumerate(names)}
    saved = payload["optimizer"]
    groups = optimizer.state_dict()["param_groups"]
    if len(groups) != len(saved["param_groups"]):
        raise ValueError(f"the checkpoint has {len(saved['param_groups'])} parameter groups, the optimizer "
                         f"{len(groups)}")
    optimizer.load_state_dict({
        "state": {index[n]: {k: _local(v, tensors[n]) for k, v in s.items()} for n, s in saved["state"].items()},
        "param_groups": [{**s, "params": g["params"]} for g, s in zip(groups, saved["param_groups"])],
    })
    train_step.steps, train_step.calls = int(payload["step"]), int(payload["calls"])
    if payload["plateau"] is not None:
        p = payload["plateau"]
        optimizer.plateau_state = PlateauState(np.float32(p["scale"]), np.float32(p["best_value"]),
                                               int(p["plateau_count"]), int(p["cooldown_count"]), int(p["count"]),
                                               np.float32(p["avg_value"]))
    generator.set_state(payload["generator"])
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    for n, g in payload["grads"].items():
        params[n].grad = _local(g, params[n]).to(params[n].device)


def save_checkpoint(directory: str, state: dict, step: Optional[int] = None) -> str:
    """Save a train state (:func:`train_state`) as ``directory/step_N/train_state.pt``; returns the folder."""
    path = Path(directory).absolute() / f"step_{int(step if step is not None else state['step'])}"
    path.mkdir(parents=True, exist_ok=True)
    torch.save(state, path / TRAIN_STATE_FILE)
    return str(path)


def _nest(flat: Dict[str, object]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def _flatten(tree: dict, prefix: str = "") -> Dict[str, object]:
    flat: Dict[str, object] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(_flatten(value, name + "."))
        else:
            flat[name] = torch.as_tensor(value)
    return flat


def _migrate_flat(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    tree, _ = migrate_fused_qkv(_nest({k: v.numpy() for k, v in flat.items()}))
    return _flatten(tree)


def _migrate_payload(payload: dict) -> tuple:
    """``(payload, changed)`` with separate q/k/v projections fused (``migrate_fused_qkv``) in the weights, the
    optimizer state (each moment tree apart; a parameter's step count from its ``q_proj``) and the gradients."""
    model = _migrate_flat(payload["model"])
    if set(model) == set(payload["model"]):
        return payload, False
    state = payload["optimizer"]["state"]
    per_key: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, s in state.items():
        for key, value in s.items():
            per_key.setdefault(key, {})[name] = value
    fused_state: Dict[str, dict] = {}
    for key, values in per_key.items():
        if all(v.ndim > 0 for v in values.values()):
            migrated = _migrate_flat(values)
        else:  # scalars (a step count): the fused parameter takes its q projection's
            migrated = {n.replace("q_proj.", "qkv_proj."): v for n, v in values.items()
                        if ".k_proj." not in n and ".v_proj." not in n}
        for name, value in migrated.items():
            fused_state.setdefault(name, {})[key] = value
    groups = [{**g, "params": None} for g in payload["optimizer"]["param_groups"]]
    return {**payload, "model": model, "optimizer": {"state": fused_state, "param_groups": groups},
            "grads": _migrate_flat(payload["grads"]) if payload["grads"] else {}}, True


def restore_checkpoint(path: str, target_state: Optional[dict] = None) -> dict:
    """Load a train state saved by :func:`save_checkpoint` (``path`` is its ``step_N`` folder).

    With ``target_state`` (the :func:`train_state` of the run that resumes), a checkpoint whose parameter names
    do not fit is first migrated from separate ``{q,k,v}_proj`` projections to the fused ``qkv_proj`` layout
    (:func:`migrate_fused_qkv`); one that still does not fit raises.
    """
    payload = torch.load(Path(path).absolute() / TRAIN_STATE_FILE, map_location="cpu", weights_only=True)
    if target_state is None or set(payload["model"]) == set(target_state["model"]):
        return payload
    payload, changed = _migrate_payload(payload)
    if not changed or set(payload["model"]) != set(target_state["model"]):
        missing = sorted(set(target_state["model"]) ^ set(payload["model"]))[:4]
        raise ValueError(f"the checkpoint at {path} does not fit the model (differing keys, first: {missing})")
    return payload
