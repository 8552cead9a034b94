"""Checkpoints: per-k flags of the NMFk sweep, and mid-solve factors.

Port of ``pydnmfk_tpu/utils/checkpoint.py`` on one device:

* the flag file and ``resume_k`` (reference utils.Checkpoint,
  pyDNMFk/utils.py:486-536, resumed in pyDNMFk.py:188-196): the sweep
  records (flag, perturbation, k, seed) as JSON after each stage, and a
  restart skips every k whose results were saved;
* :func:`solve_checkpointer`, the factors of a solve in progress
  (``_NpzSolveCheckpoint``, :99-132): one ``torch.save`` file a k, written
  beside and moved into place, with the factors at their own dtype (bf16
  and f16 too) and a tag of the configuration. A torn file or another tag
  restarts the solve from iteration 0: the checkpoint saves time and is
  never needed for a correct result.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch

# pipeline-stage flags (reference pyDNMFk.py:165)
FLAG_RUNNING = 0        # inside the perturbation loop
FLAG_PERTS_DONE = 1     # all perturbations factorized
FLAG_CLUSTERED = 2      # clustering finished
FLAG_SAVED = 3          # per-k results written


@dataclasses.dataclass
class CheckpointState:
    flag: int = FLAG_RUNNING
    perturbation: int = 0
    k: int = 0
    seed: int = 0
    version: int = 1


class Checkpoint:
    def __init__(self, results_path: str, enabled: bool = True,
                 writer: bool = True):
        """``writer``: this process writes the file (rank 0 of a grid);
        the others keep the state without writing it."""
        self.enabled = enabled
        self.writer = writer
        self.path = os.path.join(results_path, "checkpoint.json")
        self.state: Optional[CheckpointState] = None

    def load(self) -> Optional[CheckpointState]:
        if not self.enabled or not os.path.exists(self.path):
            return None
        with open(self.path) as f:
            d = json.load(f)
        self.state = CheckpointState(**{k: d[k] for k in
                                        CheckpointState.__dataclass_fields__
                                        if k in d})
        return self.state

    def save(self, flag: int, perturbation: int, k: int, seed: int = 0):
        if not self.enabled:
            return
        self.state = CheckpointState(flag=flag, perturbation=perturbation,
                                     k=k, seed=seed)
        if not self.writer:
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(self.state), f)
        os.replace(tmp, self.path)   # atomic, unlike the reference's pickle

    def resume_k(self, start_k: int, step_k: int) -> int:
        """Starting k after a resume: a k whose results were saved
        (flag == FLAG_SAVED) is skipped; an interrupted k is recomputed."""
        st = self.load()
        if st is None or st.k == 0:
            return start_k
        if st.flag >= FLAG_SAVED:
            return st.k + step_k
        return st.k


def solve_checkpointer(results_path: str, k: int, tag: str, grid=None):
    """The saver of one solve's factors (``utils/checkpoint.py:93-96``):
    one file, or on a grid one file per rank (its blocks), in place of the
    JAX package's orbax shards (:99-206)."""
    return SolveCheckpoint(results_path, k, tag, grid)


class SolveCheckpoint:
    """``results_path/solve_ckpt_k{k}`` (on a grid ``..._r{rank}``, this
    rank's blocks): W, H, the iterations done and the tag, in one
    ``torch.save`` file."""

    def __init__(self, results_path: str, k: int, tag: str, grid=None):
        suffix = "" if grid is None else f"_r{grid.rank}"
        self.path = os.path.join(results_path, f"solve_ckpt_k{k}{suffix}")
        self.tag = tag
        self.grid = grid

    def load(self, W, H):
        """(W, H, iterations done) from the file on W's device, or the
        given (W, H, 0) where there is no file, a torn one or another
        tag. On a grid every rank resumes from its file only where all
        ranks' files, of every ensemble group, hold the same iteration;
        otherwise all start at 0."""
        got = (W, H, 0)
        try:
            d = torch.load(self.path, map_location=W.device,
                           weights_only=True)
            if d["tag"] == self.tag:
                got = d["W"].contiguous(), d["H"].contiguous(), int(d["i"])
        except Exception:
            pass                      # no file or a torn one: from 0
        if self.grid is not None:
            i = got[2]
            hi, neg_lo = (int(v) for v in self.grid.max(torch.tensor(
                [i, -i], dtype=torch.float64, device=W.device),
                "world").cpu())
            if hi != -neg_lo:
                return W, H, 0
        return got

    def save(self, W, H, i: int):
        tmp = self.path + ".tmp"
        torch.save({"W": W.detach().cpu(), "H": H.detach().cpu(), "i": i,
                    "tag": self.tag}, tmp)
        os.replace(tmp, self.path)

    def cleanup(self):
        try:
            os.remove(self.path)
        except OSError:
            pass
