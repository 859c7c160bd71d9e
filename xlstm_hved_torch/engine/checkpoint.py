"""Checkpoints with the JAX package's save and restore policy (counterpart of
`xlstm_hved_tpu/engine/checkpoint.py`), on `torch.save` / `torch.load`.

- Three tracked checkpoints (latest, best_vloss, best_dice) and a backup
  every `backup_interval` epochs, in the JAX layout: <dir>/latest,
  <dir>/best_vloss, <dir>/best_dice, <dir>/backups/epoch<N>, each a
  directory holding `state.pt`, beside it `<name>.meta.json` (epoch, this
  epoch's metrics, the bests).
- A checkpoint holds what the JAX train state holds: the step, G's and D's
  weights with G's BatchNorm statistics, and both optimizers' states. The
  random generators are not saved: a resumed run draws afresh from its
  seed, as the JAX CLI does.
- Resume restores all of it into a built `TrainState` and returns the next
  epoch and the bests.
- Pretrained-weight surgery copies the parameters whose name and shape
  match (a non-strict load).
- The parameters are fp32 whatever the compute dtype, and the names are
  the same with and without remat, so a checkpoint of a bf16 or remat run
  loads into an fp32 model, and the other way round, with `strict=True`.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

_STATE_FILE = "state.pt"


def _state_dict(state) -> Dict[str, Any]:
    return {"step": int(state.step),
            "model": state.model.state_dict(),
            "disc": state.disc.state_dict(),
            "opt_g": state.opt_g.state_dict(),
            "opt_d": state.opt_d.state_dict()}


class CheckpointManager:
    def __init__(self, out_dir: str, backup_interval: int = 5):
        self.out_dir = os.path.abspath(out_dir)
        self.backup_interval = backup_interval
        os.makedirs(os.path.join(self.out_dir, "backups"), exist_ok=True)

    # ---------- paths ----------
    def _path(self, name: str) -> str:
        return os.path.join(self.out_dir, name)

    def _meta_path(self, name: str) -> str:
        return os.path.join(self.out_dir, f"{name}.meta.json")

    # ---------- save ----------
    def _save(self, name: str, state, meta: Dict[str, Any]):
        path = self._path(name)
        os.makedirs(path, exist_ok=True)
        # write beside, then rename: a checkpoint is never half-written
        tmp = os.path.join(path, _STATE_FILE + ".tmp")
        torch.save(_state_dict(state), tmp)
        os.replace(tmp, os.path.join(path, _STATE_FILE))
        with open(self._meta_path(name), "w") as f:
            json.dump(meta, f)

    def save_epoch(self, state, epoch: int, vloss: Optional[float],
                   dice: Optional[float], best_vloss: float,
                   best_dice: float) -> Tuple[float, float]:
        """Always save latest; best_vloss / best_dice on improvement; a
        backup every backup_interval epochs. Returns the updated bests.

        Pass vloss / dice as None on epochs without validation: latest and
        the backup are still written, the bests are not touched."""
        validated = vloss is not None and dice is not None
        meta = dict(epoch=epoch,
                    vloss=float(vloss) if validated else None,
                    dice=float(dice) if validated else None,
                    best_vloss=float(best_vloss), best_dice=float(best_dice))
        if epoch % self.backup_interval == 0:
            self._save(os.path.join("backups", f"epoch{epoch}"), state, meta)
        if validated and vloss < best_vloss:
            best_vloss = float(vloss)
            meta["best_vloss"] = best_vloss
            self._save("best_vloss", state, meta)
        if validated and dice > best_dice:
            best_dice = float(dice)
            meta["best_dice"] = best_dice
            self._save("best_dice", state, meta)
        meta["best_vloss"], meta["best_dice"] = best_vloss, best_dice
        self._save("latest", state, meta)
        return best_vloss, best_dice

    # ---------- restore ----------
    def exists(self, name: str = "latest") -> bool:
        return os.path.isfile(os.path.join(self._path(name), _STATE_FILE))

    def restore_raw(self, name: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """The saved dict (step, model, disc, opt_g, opt_d; tensors on the
        CPU) and its meta, for weight surgery: no module is needed, so a
        donor whose tree differs from the target's loads."""
        saved = torch.load(os.path.join(self._path(name), _STATE_FILE),
                           map_location="cpu", weights_only=True)
        meta: Dict[str, Any] = {}
        if os.path.exists(self._meta_path(name)):
            with open(self._meta_path(name)) as f:
                meta = json.load(f)
        return saved, meta

    def restore(self, name: str, state) -> Tuple[Any, Dict[str, Any]]:
        """Load checkpoint `name` into `state` (a TrainState) in place: the
        modules strictly, both optimizers, the step."""
        saved, meta = self.restore_raw(name)
        state.model.load_state_dict(saved["model"], strict=True)
        state.disc.load_state_dict(saved["disc"], strict=True)
        state.opt_g.load_state_dict(saved["opt_g"])
        state.opt_d.load_state_dict(saved["opt_d"])
        state.step = int(saved["step"])
        return state, meta

    def load_or_initialize(self, state, name: str = "latest"):
        """(state, epoch_start, best_vloss, best_dice): (state, 1, inf, 0.0)
        on a fresh start, else the restored state and the saved epoch + 1."""
        if not self.exists(name):
            return state, 1, float("inf"), 0.0
        state, meta = self.restore(name, state)
        return (state, int(meta.get("epoch", 0)) + 1,
                float(meta.get("best_vloss", float("inf"))),
                float(meta.get("best_dice", 0.0)))


def surgical_restore(model: nn.Module, donor_state: Mapping[str, torch.Tensor],
                     verbose: bool = False) -> Tuple[List[str], List[str]]:
    """Copy into `model` every parameter (`named_parameters`, not buffers)
    whose name is in `donor_state` with the same shape. Returns (loaded,
    skipped) parameter names."""
    loaded, skipped = [], []
    with torch.no_grad():
        for name, p in model.named_parameters():
            src = donor_state.get(name)
            if src is not None and tuple(src.shape) == tuple(p.shape):
                p.copy_(src)
                loaded.append(name)
            else:
                skipped.append(name)
    if verbose:
        print(f"surgical_restore: loaded {len(loaded)}, skipped {len(skipped)}")
    return loaded, skipped
