"""Per-k checkpoint flags and resume for the NMFk sweep.

Port of the flag file and ``resume_k`` of ``pydnmfk_tpu/utils/checkpoint.py``
(reference utils.Checkpoint, pyDNMFk/utils.py:486-536, resumed in
pyDNMFk.py:188-196): the sweep records (flag, perturbation, k, seed) as JSON
after each stage, and a restart skips every k whose results were saved.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

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
    def __init__(self, results_path: str, enabled: bool = True):
        self.enabled = enabled
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
