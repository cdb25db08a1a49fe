"""Checkpoints with true resume (after `bist_tpu.train.checkpoint`, with
`torch.save` in place of orbax).

The reference pickles the whole nn.Module per best epoch with no optimizer
state and no resume path (train.py:156-177).  Here a checkpoint is one file,
`<path>.pt`, holding {"params", "opt_state", "step", "meta"} (meta: epoch,
best valid loss, extras) as CPU tensors and plain values; the `.conf` JSON
(config.save_conf) carries vocab + configs — together they restore a run.
A checkpoint is written to a temporary name beside it and then renamed into
place, so `<path>.pt` is always a complete file.  `weights.load_params`
reads its parameters, so `cli.generate --model <model>_best` loads what the
trainer wrote.
"""

from __future__ import annotations

import glob
import os
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from bist_tpu_torch.weights import tree_leaves, tree_map

TMP_TAG = ".tmp-"


def checkpoint_file(path: str) -> str:
    return path if path.endswith(".pt") else path + ".pt"


def _payload(state, epoch: int, best_valid_loss: float,
             extra: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The state as CPU copies: the caller may update its tensors as soon
    as this returns."""
    host = lambda t: t.detach().to("cpu", copy=True)
    opt = state.opt_state
    return {"params": tree_map(host, state.params),
            "opt_state": {"count": int(opt["count"]),
                          "mu": [host(t) for t in opt["mu"]],
                          "nu": [host(t) for t in opt["nu"]]},
            "step": int(state.step),
            "meta": {"epoch": epoch, "best_valid_loss": float(best_valid_loss),
                     **(extra or {})}}


def _write(path: str, payload: Dict[str, Any]) -> None:
    path = os.path.abspath(checkpoint_file(path))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}{TMP_TAG}{os.getpid()}-{threading.get_ident()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state, *, epoch: int = 0,
                    best_valid_loss: float = float("inf"),
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write `<path>.pt` (overwrites)."""
    _write(path, _payload(state, epoch, best_valid_loss, extra))


def find_latest_checkpoint(model_prefix: str) -> Optional[str]:
    """Newest complete checkpoint file for a model prefix, or None.

    Candidates are `<prefix>_best.pt` and `<prefix>_<N>.pt` (the two names
    the train CLI writes); 'newest' is the file's mtime — the last completed
    write is by construction the latest training state.  Temporaries of an
    unfinished write (`...pt.tmp-*`) are not candidates, so `--resume auto`
    after a kill picks the last complete save."""
    base = os.path.basename(model_prefix)
    cands = []
    for p in glob.glob(glob.escape(model_prefix) + "_*.pt"):
        suffix = os.path.basename(p)[len(base) + 1:-len(".pt")]
        if (suffix == "best" or suffix.isdigit()) and os.path.getsize(p) > 0:
            cands.append(p)
    return max(cands, key=os.path.getmtime) if cands else None


class AsyncSaver:
    """Checkpoint writes off the training thread.  save() copies the state
    to host memory before it returns (so the caller may update its tensors
    at once) and writes the file on a background thread; wait() joins the
    write in flight.  At most one write is in flight: save() joins the
    previous one first."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: list = []

    def save(self, path: str, state, *, epoch: int = 0,
             best_valid_loss: float = float("inf"),
             extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        payload = _payload(state, epoch, best_valid_loss, extra)

        def write():
            try:
                _write(path, payload)
            except BaseException as e:      # raised in the caller by wait()
                self._error.append(e)

        self._thread = threading.Thread(target=write, daemon=False)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error.pop()


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(checkpoint_file(path), map_location="cpu", weights_only=True)


def restore_train_state(path: str, template_state) -> Tuple[Any, Dict[str, Any]]:
    """The TrainState saved at `path`, on the template's device and with its
    tree (parameters that require grad), and the checkpoint's meta."""
    payload = load_checkpoint(path)
    leaves = tree_leaves(template_state.params)
    saved = tree_leaves(payload["params"])
    if len(saved) != len(leaves):
        raise ValueError(f"checkpoint {path}: {len(saved)} parameters, the model "
                         f"has {len(leaves)}")
    with torch.no_grad():
        for t, s in zip(leaves, saved):
            t.copy_(s)
    dev = leaves[0].device
    opt = payload["opt_state"]
    opt_state = {"count": int(opt["count"]),
                 "mu": [t.to(dev) for t in opt["mu"]],
                 "nu": [t.to(dev) for t in opt["nu"]]}
    return (type(template_state)(template_state.params, opt_state,
                                 int(payload["step"])), payload.get("meta", {}))
