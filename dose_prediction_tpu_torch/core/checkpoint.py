"""Checkpoints and cross-model weight surgery (counterpart of
dose_prediction_tpu/core/checkpoint.py).

The JAX package writes orbax trees; the port writes its own format. A slot is
one file, a ``torch.save`` of ``{"model": state_dict, "optimizer":
state_dict, "step", "moving_loss", "epoch"}`` (and any other number the
caller puts in the tree, such as the 'best_train_loss' slot's "loss"). It
is written under a hidden temporary name in the same directory and moved
into place with ``os.replace``, so a crash never leaves a half-written slot
under a real name; a leftover temporary file is never read.

Layout under the checkpoint directory:
``monitored/<step>.pt`` (the metric-ranked saves, ``monitored/index.json``
their metrics), ``last.pt`` (the every-epoch crash-resume slot), ``<name>.pt``
(named slots), ``iter_<step>.pt`` (never-rotated archival snapshots) and
``run_config.json``. Writes are synchronous: eager PyTorch has no commit
threads to drain, so ``wait()`` has nothing to wait for.

A ``tree`` is ``{"state": TrainState, "epoch": int, ...}``, or for a GAN
``{"g": TrainState, "d": TrainState, "epoch": int}``: the "state" entry's
model, optimizer, step and moving loss are stored at the slot's top level,
any other TrainState's as a dict of the same keys under its own name.
Restoring with a template is strict and checks before it changes anything:
every model entry's name and shape, the optimizer's kind, groups and state
shapes; then the template's models and optimizers are loaded in place and a
new tree is returned. Without a template a restore returns the file's
dict, on the CPU.

A state sharded over a mesh (its ``plan``, parallel/mesh.py) is written as
whole leaves under the single-device names: every rank gathers, rank 0
writes, and every rank waits until the slot is in place. A restore on a
mesh reads the whole leaves and keeps this rank's parts, so a slot written
on a mesh resumes on one device and the other way round.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from dose_prediction_tpu_torch.parallel.collectives import barrier
from dose_prediction_tpu_torch.train.state import TrainState

SUFFIX = ".pt"


def _state_payload(state: TrainState) -> Dict[str, Any]:
    if state.plan is None:
        model, optimizer = state.model.state_dict(), state.optimizer.state_dict()
    else:     # on a mesh: whole leaves, gathered by every rank
        model = state.plan.whole_model_state(state.model)
        optimizer = state.plan.whole_optimizer_state(state.optimizer)
    return {"model": model, "optimizer": optimizer,
            "step": int(state.step), "moving_loss": float(state.moving_loss)}


def _mesh_of(tree: Any):
    """The mesh a trainer tree's states are sharded over, or None."""
    if not _is_trainer_tree(tree):
        return None
    plans = [v.plan for v in tree.values() if isinstance(v, TrainState) and v.plan is not None]
    return plans[0].mesh if plans else None


def _writes(tree: Any) -> bool:
    """Whether this process writes ``tree``'s slot: on a mesh, rank 0 only."""
    mesh = _mesh_of(tree)
    return mesh is None or mesh.writes


def _payload(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The dict a slot stores for ``tree`` (module docstring)."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if k == "state":
            out.update(_state_payload(v))
        else:
            out[k] = _state_payload(v) if isinstance(v, TrainState) else v
    return out


def _is_trainer_tree(tree: Any) -> bool:
    return isinstance(tree, Mapping) and any(isinstance(v, TrainState) for v in tree.values())


def save_checkpoint(path: str | Path, tree: Any) -> int:
    """Write ``tree`` (a trainer tree, or any dict of tensors and numbers)
    to ``path`` atomically; returns the bytes written."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = _payload(tree) if _is_trainer_tree(tree) else tree
    mesh = _mesh_of(tree)
    if _writes(tree):
        tmp = path.parent / f".{path.name}.tmp-{os.getpid()}"
        try:
            torch.save(payload, tmp)
            os.replace(tmp, path)
        finally:
            if tmp.exists():
                tmp.unlink()
    if mesh is not None:       # every rank returns once the slot is in place
        barrier(mesh.device)
    return path.stat().st_size


def _check_model(model: torch.nn.Module, saved: Mapping[str, torch.Tensor]) -> None:
    mine = model.state_dict()
    missing = sorted(set(mine) - set(saved))
    extra = sorted(set(saved) - set(mine))
    if missing or extra:
        raise ValueError(f"checkpoint does not match the model: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    bad = [(k, tuple(saved[k].shape), tuple(v.shape)) for k, v in mine.items()
           if tuple(saved[k].shape) != tuple(v.shape)]
    if bad:
        raise ValueError(f"checkpoint shapes do not match the model: {bad[:5]}")


def restore_checkpoint(path: str | Path, target: Optional[Mapping[str, Any]] = None) -> Any:
    """Read a slot. With ``target`` (a tree) the slot is checked against it
    and loaded into its model and optimizer (module docstring); a missing
    entry or a mismatch raises ValueError."""
    payload = torch.load(Path(path), map_location="cpu", weights_only=True)
    if target is None:
        return payload
    states = {k: v for k, v in target.items() if isinstance(v, TrainState)}
    saved = {k: payload if k == "state" else (payload.get(k) if isinstance(payload, dict) else None)
             for k in states}
    if any(not isinstance(v, dict) or "model" not in v or "optimizer" not in v
           for v in saved.values()):
        raise ValueError(f"{path}: not a trainer slot of {sorted(states)}")
    missing = [k for k in target if k not in states and k not in payload]
    if missing:
        raise ValueError(f"{path}: the slot has no {missing}")
    for k, state in states.items():
        if state.plan is not None:     # whole leaves → this rank's parts
            saved[k] = {**saved[k],
                        "model": state.plan.local_model_state(saved[k]["model"], state.model),
                        "optimizer": state.plan.local_optimizer_state(saved[k]["optimizer"],
                                                                      state.optimizer)}
        _check_model(state.model, saved[k]["model"])
        state.optimizer.check_state_dict(saved[k]["optimizer"])
    out = {k: payload[k] for k in target if k not in states}
    for k, state in states.items():
        state.model.load_state_dict(saved[k]["model"], strict=True)
        state.optimizer.load_state_dict(saved[k]["optimizer"])
        out[k] = dataclasses.replace(state, step=int(saved[k]["step"]),
                                     moving_loss=float(saved[k]["moving_loss"]))
    return out


def variables_from_checkpoint(tree: Any) -> Dict[str, torch.Tensor]:
    """A model state dict from whatever a slot holds: a trainer slot
    (``{"model": ...}``; a GAN slot's generator, ``{"g": {"model": ...}}``)
    or a bare state dict (what import-torch writes)
    (variables_from_checkpoint, :69-85)."""
    if isinstance(tree, Mapping) and isinstance(tree.get("g"), Mapping):
        tree = tree["g"]
    if isinstance(tree, Mapping) and isinstance(tree.get("model"), Mapping):
        return dict(tree["model"])
    return dict(tree)


class CheckpointManager:
    """Best-k rotation by a monitored metric, the 'last' crash-resume slot,
    named slots and archival snapshots (the JAX CheckpointManager, :88-268;
    ModelCheckpoint(save_last, monitor), train_light_pyfer.py:307-312)."""

    def __init__(self, directory: str | Path, *, max_to_keep: int = 3,
                 monitor: str = "dose_score", mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._monitored = self._dir / "monitored"
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        self.mode = mode

    # -- monitored saves -----------------------------------------------------
    def _index(self) -> Dict[int, Dict[str, float]]:
        """Metrics of the monitored steps whose slot exists."""
        try:
            raw = json.loads((self._monitored / "index.json").read_text())
        except (OSError, ValueError):
            return {}
        return {int(k): v for k, v in raw.items()
                if (self._monitored / f"{int(k)}{SUFFIX}").exists()}

    def _write_index(self, index: Dict[int, Dict[str, float]]) -> None:
        tmp = self._monitored / ".index.json.tmp"
        tmp.write_text(json.dumps({str(k): v for k, v in sorted(index.items())}))
        os.replace(tmp, self._monitored / "index.json")

    def _ranked(self, index: Dict[int, Dict[str, float]]) -> list:
        """Steps from best to worst by the monitored metric (ties: newer first)."""
        sign = -1.0 if self.mode == "max" else 1.0
        return sorted(index, key=lambda s: (sign * float(index[s][self.monitor]), -s))

    def save(self, step: int, tree: Any, metrics: Dict[str, float]) -> None:
        """Monitored save of ``tree`` at ``step``; then only the best
        ``max_to_keep`` by ``monitor`` stay."""
        self._monitored.mkdir(exist_ok=True)
        save_checkpoint(self._monitored / f"{int(step)}{SUFFIX}", tree)
        if not _writes(tree):
            return
        index = self._index()
        index[int(step)] = {k: float(v) for k, v in metrics.items()}
        keep = self._ranked(index)[:self.max_to_keep]
        for s in set(index) - set(keep):
            (self._monitored / f"{s}{SUFFIX}").unlink(missing_ok=True)
            del index[s]
        self._write_index(index)

    def all_steps(self) -> list:
        return sorted(self._index())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        ranked = self._ranked(self._index())
        return ranked[0] if ranked else None

    def step_path(self, step: int) -> Path:
        return self._monitored / f"{int(step)}{SUFFIX}"

    def restore_latest(self, target: Optional[Any] = None) -> Tuple[Optional[int], Any]:
        step = self.latest_step()
        if step is None:
            return None, None
        return step, restore_checkpoint(self.step_path(step), target)

    def restore_best(self, target: Optional[Any] = None) -> Tuple[Optional[int], Any]:
        step = self.best_step()
        if step is None:
            return None, None
        return step, restore_checkpoint(self.step_path(step), target)

    # -- named slots: 'last', 'best_train_loss', 'iter_<step>' ---------------
    def named_path(self, name: str) -> Path:
        return self._dir / f"{name}{SUFFIX}"

    def save_last(self, tree: Any) -> None:
        """Overwrite the 'last' crash-resume slot (network_trainer.py:305-313)."""
        self.save_named("last", tree)

    def save_named(self, name: str, tree: Any) -> None:
        """Overwrite the slot ``<dir>/<name>.pt``."""
        save_checkpoint(self.named_path(name), tree)

    def restore_named(self, name: str, target: Optional[Any] = None) -> Any:
        path = self.named_path(name)
        if not path.exists():
            return None
        return restore_checkpoint(path, target)

    def restore_last(self, target: Optional[Any] = None) -> Any:
        return self.restore_named("last", target)

    def save_snapshot(self, step: int, tree: Any) -> None:
        """The never-rotated ``iter_<step>`` archival slot (NetworkTrainer
        save_per_epoch, network_trainer.py:304-307)."""
        self.save_named(f"iter_{step}", tree)

    def snapshots(self) -> list:
        """Global steps of the archival iter_* slots, ascending."""
        out = []
        for child in self._dir.iterdir():
            stem = child.name[:-len(SUFFIX)] if child.name.endswith(SUFFIX) else ""
            if stem.startswith("iter_") and stem[5:].isdigit():
                out.append(int(stem[5:]))
        return sorted(out)

    def restore_snapshot(self, step: int, target: Optional[Any] = None) -> Any:
        return self.restore_named(f"iter_{step}", target)

    # -- the run-config sidecar (checked by train.trainers._try_resume) ------
    def write_run_config(self, spec: dict) -> None:
        """Atomically record the run's graph-determining settings
        (``<dir>/run_config.json``)."""
        tmp = self._dir / f".run_config.json.tmp-{os.getpid()}"
        tmp.write_text(json.dumps(spec, indent=2, sort_keys=True, default=str))
        os.replace(tmp, self._dir / "run_config.json")

    def read_run_config(self) -> Optional[dict]:
        try:
            return json.loads((self._dir / "run_config.json").read_text())
        except (OSError, ValueError):
            return None

    def wait(self) -> None:
        """Every write has finished when its call returns: nothing to wait for."""


# ---------------------------------------------------------------------------
# weight surgery on state dicts ('.'-separated names)
# ---------------------------------------------------------------------------

def flatten_params(tree: Mapping[str, Any]) -> Dict[Tuple[str, ...], Any]:
    """{name path: leaf} of a state dict (or nested dicts of leaves)."""
    out: Dict[Tuple[str, ...], Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update({(k,) + p: leaf for p, leaf in flatten_params(v).items()})
        else:
            out[tuple(k.split("."))] = v
    return out


def merge_partial(target: Mapping[str, Any], source: Mapping[str, Any], *,
                  keep_if: Optional[Callable[[Tuple[str, ...]], bool]] = None,
                  require_shape_match: bool = True, verbose: bool = True
                  ) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """strict=False partial restore (:288-329): copy every source entry
    whose name is in the target (optionally filtered by ``keep_if`` and by
    equal shapes), leaving the rest of the target as it is. Returns the
    merged state dict (the target's names and order) and the counts the
    reference prints (dose_pyfer.py:396-401)."""
    tgt = {tuple(k.split(".")): k for k in target}
    src = flatten_params(source)
    inside = [k for k in src if k in tgt]
    stats = {"missing": sum(k not in src for k in tgt), "inside": len(inside),
             "unused": sum(k not in tgt for k in src), "copied": 0}
    merged = dict(target)
    for k in inside:
        if keep_if is not None and not keep_if(k):
            continue
        if require_shape_match and tuple(src[k].shape) != tuple(target[tgt[k]].shape):
            continue
        merged[tgt[k]] = src[k]
        stats["copied"] += 1
    if verbose:
        print(f"[surgery] missing={stats['missing']} inside={stats['inside']} "
              f"unused={stats['unused']} copied={stats['copied']}")
    return merged, stats


def load_pretrained_net_a(cascade_sd: Mapping[str, Any], c3d_sd: Mapping[str, Any], *,
                          verbose: bool = True) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """create_pretrained_unet (c3d.py:200-203 → dose_pyfer.py:405-406): copy
    only the net_A and conv_out_A entries of a trained C3D cascade into a
    DOSE-PYFER state dict (:332-342)."""
    return merge_partial(cascade_sd, c3d_sd,
                         keep_if=lambda keys: any(k in ("net_A", "conv_out_A") for k in keys),
                         verbose=verbose)


def strip_prefix(tree: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """Drop a leading name component ``prefix`` where present
    (train_light_transeg.py:130: '_model.' → '')."""
    out = {}
    for k, v in tree.items():
        first, _, rest = k.partition(".")
        out[rest if first == prefix and rest else k] = v
    return out
