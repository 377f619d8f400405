"""Checkpoints of the train state (counterpart of
``implicit_depth_tpu/train/checkpoint.py``, with torch files in place of
orbax).

A checkpoint is a directory ``<ckpt_dir>/<name>/`` holding ``state.pt``:
{"model": the model's ``state_dict`` (parameters and BatchNorm
statistics), "optimizer": the optimizer's ``state_dict`` (or None),
"step": the count of updates}, every tensor saved from a CPU copy, so that
a checkpoint written on the card loads on the CPU and back. Metadata (the
epoch, best metrics) rides in a JSON sidecar ``<name>.meta.json``, since
``torch.load(weights_only=True)`` refuses pickled objects. ``save`` writes
``latest_network`` and, with ``snapshot``, ``epochNNN_network``; ``save_as``
any name (``best_network``). Each write is crash-safe: the new checkpoint
goes to ``<name>.next`` and is swapped in by renames through
``<name>.prev``, so that a complete checkpoint is on disk at every instant
and a restore falls back to ``.prev``.

``Checkpointer.restore`` is strict when the checkpoint fits the state
(same parameter names and shapes, an optimizer state of the same
structure); otherwise it merges shape-tolerantly (:func:`merge_compatible`:
each tensor whose name and shape match is taken, every other keeps the
state's value) and keeps the state's optimizer state unless the saved one
has the same structure. :func:`restore_params_only` loads the parameters
and BatchNorm statistics alone (the frozen stage 1 of stage-2 training, and
``DepthCompleter.from_checkpoint``). :func:`generator_state` /
:func:`set_generator_state` carry a ``torch.Generator`` through the JSON
sidecar (the trainer's mid-epoch checkpoints).

Under a process group (``parallel/mesh.py``) rank 0 alone writes, and
every rank waits at a barrier after each save, so that no rank runs on
before the checkpoint is whole (JAX ``checkpoint.py``: process 0 saves);
every rank restores from the same files.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from implicit_depth_torch.parallel import mesh
from implicit_depth_torch.train.state import TrainState

LATEST = "latest_network"
EPOCH_FMT = "epoch{:03d}_network"
_FILE = "state.pt"

State = Union[TrainState, nn.Module]


def _cpu(tree: Any) -> Any:
    """``tree`` with every tensor copied to the CPU (the optimizer state's
    nesting of dicts, lists and tuples kept)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _parts(state: State) -> Tuple[nn.Module, Optional[torch.optim.Optimizer]]:
    if isinstance(state, TrainState):
        return state.model, state.optimizer
    if isinstance(state, nn.Module):
        return state, None
    raise TypeError(f"cannot checkpoint a {type(state).__name__}")


def _tree(state: State) -> Dict[str, Any]:
    model, opt = _parts(state)
    return {"model": _cpu(model.state_dict()),
            "optimizer": None if opt is None else _cpu(opt.state_dict()),
            "step": int(getattr(state, "step", 0))}


def _load(path: str) -> Dict[str, Any]:
    return torch.load(os.path.join(path, _FILE), map_location="cpu",
                      weights_only=True)


class Checkpointer:
    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        if mesh.is_main():
            os.makedirs(self.ckpt_dir, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, state: State, epoch: int, meta: Optional[Dict] = None,
             snapshot: bool = False) -> None:
        """``state`` (a TrainState, or a bare module) as ``latest_network``,
        and as ``epochNNN_network`` when ``snapshot``."""
        if mesh.is_main():
            tree, meta = _tree(state), dict(meta or {}, epoch=epoch)
            self._write(os.path.join(self.ckpt_dir, LATEST), tree, meta)
            if snapshot:
                self._write(os.path.join(self.ckpt_dir,
                                         EPOCH_FMT.format(epoch)), tree, meta)
        mesh.barrier()

    def save_as(self, state: State, epoch: int, name: str,
                meta: Optional[Dict] = None) -> None:
        """``state`` under ``name`` (e.g. ``best_network``)."""
        if mesh.is_main():
            self._write(os.path.join(self.ckpt_dir, name), _tree(state),
                        dict(meta or {}, epoch=epoch))
        mesh.barrier()

    def _write(self, path: str, tree: Dict[str, Any], meta: Dict) -> None:
        """Crash-safe overwrite: write ``<path>.next``, then swap it in by
        renames, the previous checkpoint kept as ``<path>.prev`` until the
        new one is in place (``_resolve`` falls back to it)."""
        nxt, prev = path + ".next", path + ".prev"
        _remove(nxt)  # a killed save's leftovers
        os.makedirs(nxt)
        torch.save(tree, os.path.join(nxt, _FILE))
        with open(nxt + ".meta.json", "w") as f:
            json.dump(meta, f)
        _remove(prev)
        if os.path.isdir(path):
            os.rename(path, prev)
            if os.path.exists(path + ".meta.json"):
                os.replace(path + ".meta.json", prev + ".meta.json")
        os.rename(nxt, path)
        os.replace(nxt + ".meta.json", path + ".meta.json")
        # the swap is complete: drop the safety copy (a crash right here
        # leaves a stale .prev for the next save to clean up)
        _remove(prev)

    # -- restore ------------------------------------------------------------
    def restore(self, state: State, name: str = LATEST) -> Tuple[State, Dict]:
        """Load the checkpoint ``name`` into ``state`` (in place; returned
        with the metadata): strictly when it fits, else by the shape-tolerant
        merge, with the optimizer state kept as it is unless the saved one
        has the same structure."""
        path = self._resolve(name)
        raw = _load(path)
        model, opt = _parts(state)
        template = model.state_dict()
        saved = raw.get("model", {})
        fits = (set(saved) == set(template) and all(
            saved[k].shape == template[k].shape for k in template))
        opt_state = raw.get("optimizer")
        if fits and (opt is None or _opt_state_fits(opt, opt_state)):
            model.load_state_dict(saved, strict=True)
            if opt is not None:
                opt.load_state_dict(opt_state)
        else:
            print("ckpt restore: strict load failed (the checkpoint does not "
                  "fit the state), falling back to shape-tolerant merge")
            model.load_state_dict(merge_compatible(template, saved, "model"))
            if opt is not None:
                if _opt_state_fits(opt, opt_state):
                    opt.load_state_dict(opt_state)
                else:
                    print("ckpt restore: optimizer state incompatible, "
                          "reinitialized")
        if isinstance(state, TrainState):
            state.step = int(raw.get("step", state.step))
        return state, self._read_meta(path)

    def _read_meta(self, path: str) -> Dict:
        for mp in (path + ".meta.json",
                   path[:-len(".prev")] + ".meta.json"
                   if path.endswith(".prev") else None):
            if mp and os.path.exists(mp):
                with open(mp) as f:
                    return json.load(f)
        return {}

    def _resolve(self, name: str) -> str:
        return _resolve(self.ckpt_dir, name)

    def latest_exists(self) -> bool:
        base = os.path.join(self.ckpt_dir, LATEST)
        return os.path.isdir(base) or os.path.isdir(base + ".prev")

    def list_snapshots(self):
        pat = re.compile(r"epoch(\d+)_network$")
        return sorted(int(m.group(1)) for m in
                      map(pat.match, os.listdir(self.ckpt_dir)) if m)


def _remove(path: str) -> None:
    """Delete the checkpoint directory ``path`` and its sidecar, if there."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    if os.path.exists(path + ".meta.json"):
        os.remove(path + ".meta.json")


def _resolve(ckpt_dir: str, name: str) -> str:
    """The path of checkpoint ``name``; its ``.prev`` when a crash hit
    between the two renames of a save."""
    path = os.path.join(os.path.abspath(ckpt_dir), name)
    if not os.path.isdir(path) and os.path.isdir(path + ".prev"):
        print(f"ckpt restore: {name} incomplete, using {name}.prev")
        return path + ".prev"
    return path


def _opt_state_fits(opt: torch.optim.Optimizer, saved: Any) -> bool:
    """Whether a saved optimizer ``state_dict`` has the structure of
    ``opt``'s: the same groups of the same sizes, and per parameter the
    same state entries with the shapes ``opt`` would give them (those of
    the entries it holds, as L-BFGS holds its state from the start; else
    the parameter's)."""
    if not isinstance(saved, dict) or "param_groups" not in saved:
        return False
    groups = opt.param_groups
    if len(groups) != len(saved["param_groups"]) or any(
            len(g["params"]) != len(s["params"])
            for g, s in zip(groups, saved["param_groups"])):
        return False
    params = [p for g in groups for p in g["params"]]
    ids = [i for s in saved["param_groups"] for i in s["params"]]
    for p, i in zip(params, ids):
        st, own = saved["state"].get(i, {}), opt.state.get(p, {})
        if own and set(st) != set(own):
            return False
        for k, v in st.items():
            want = own[k].shape if torch.is_tensor(own.get(k)) else p.shape
            if torch.is_tensor(v) and v.dim() > 0 and v.shape != want:
                return False
    return True


def merge_compatible(target: Any, loaded: Any, path: str = "") -> Any:
    """Shape-tolerant merge: the ``loaded`` tensor wherever its name and
    shape match ``target``'s (cast to the target's dtype and device), the
    target's own value elsewhere, each miss reported. Nested dicts merge
    entry by entry."""
    if isinstance(target, dict):
        if not isinstance(loaded, dict):
            print(f"ckpt merge: subtree mismatch at {path!r}, keeping target")
            return target
        out = type(target)()
        for k, v in target.items():
            if k in loaded:
                out[k] = merge_compatible(v, loaded[k], f"{path}/{k}")
            else:
                print(f"ckpt merge: missing {path}/{k}, keeping target")
                out[k] = v
        return out
    if not torch.is_tensor(loaded):
        print(f"ckpt merge: unreadable leaf at {path!r}, keeping target")
        return target
    if tuple(target.shape) != tuple(loaded.shape):
        print(f"ckpt merge: shape mismatch at {path!r} "
              f"({tuple(loaded.shape)} vs {tuple(target.shape)}), keeping "
              "target")
        return target
    return loaded.to(dtype=target.dtype, device=target.device)


def restore_params_only(ckpt_dir: str, model: nn.Module,
                        name: str = LATEST) -> nn.Module:
    """Load the parameters and BatchNorm statistics of checkpoint ``name``
    into ``model`` (the frozen stage 1 of stage-2 training, a served model),
    shape-tolerantly: a mismatched or missing tensor keeps ``model``'s
    value. No optimizer state is read. Returns ``model``."""
    raw = _load(_resolve(ckpt_dir, name))
    template = model.state_dict()
    model.load_state_dict(merge_compatible(template, raw.get("model", {}),
                                           "model"))
    return model


def generator_state(gen: torch.Generator) -> Dict[str, Any]:
    """The state of ``gen`` for a checkpoint's JSON sidecar: its device type
    and the bytes of ``get_state()`` (a CUDA generator's seed and offset, a
    CPU generator's Mersenne Twister) as a list of ints."""
    return {"device": gen.device.type, "state": gen.get_state().tolist()}


def set_generator_state(gen: torch.Generator, saved: Dict[str, Any]) -> None:
    """Restore :func:`generator_state` into ``gen``. A state taken on the
    same device type is set as it was; one from the other device type (a
    CPU run resumed on the card, or back) cannot continue its stream there,
    so ``gen`` is seeded from a hash of the saved bytes instead: the resumed
    draws are then a fixed function of the checkpoint, though not the ones
    the interrupted run would have made."""
    state = torch.tensor(saved["state"], dtype=torch.uint8)
    if saved["device"] == gen.device.type:
        gen.set_state(state)
        return
    seed = int.from_bytes(hashlib.sha256(state.numpy().tobytes()).digest()[:8],
                          "little") & (2 ** 63 - 1)
    print(f"ckpt restore: generator state from {saved['device']} reseeds the "
          f"{gen.device.type} generator ({seed})")
    gen.manual_seed(seed)
