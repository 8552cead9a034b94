"""Back-to-back NMF fits through ``pydnmfk_tpu_torch.NMF(cfg).fit``.

Each fit is the reference's timed unit: ``itr`` MU iterations from U[0, 1)
factors that the benchmark draws for it, then the final normalization and
the relative error, read to the host. A is drawn once from the seed.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import gen, work
from ..reference import compare, nmf as ref


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.kept = []

    def setup(self):
        import pydnmfk_tpu_torch as port
        cfg, t = self.cfg, self.traffic
        # the configuration's float32 is true float32
        torch.backends.cuda.matmul.allow_tf32 = False
        self.port = port
        self.A = gen.planted_exact(cfg["m"], cfg["n"], cfg["a_rank"],
                                   cfg["a_top"], self.seed, self.device)
        self.nmf_cfg = port.NMFConfig(
            k=cfg["k"], itr=cfg["itr"], init=cfg["init"], norm=t["norm"],
            method=t["method"], precision=cfg["precision"],
            seed=gen.derived_seed(self.seed, "nmf"))
        self._fit("warmup")

    def _factors(self, tag):
        return gen.rand_factors(self.cfg["m"], self.cfg["n"], self.cfg["k"],
                                self.seed, self.device, tag)

    def _fit(self, tag):
        model = self.port.NMF(self.nmf_cfg, device=self.device)
        return model.fit(self.A, factors=self._factors(tag))

    def run(self, seconds: float, tracing: bool = False) -> dict:
        """Fits until ``seconds`` have passed; keeps a sample of the
        answers, drawn from the seed, for :meth:`check`."""
        rng = np.random.default_rng(gen.derived_seed(self.seed, "sample"))
        want = int(self.traffic["check_solves"])
        t0 = time.perf_counter()
        done = 0
        while True:
            W, H, err = self._fit(done)
            # reservoir sampling: every fit equally likely to be checked
            slot = done if done < want else int(rng.integers(done + 1))
            if slot < want:
                item = (done, W, H, err)
                if slot < len(self.kept):
                    self.kept[slot] = item
                else:
                    self.kept.append(item)
            done += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window = time.perf_counter() - t0
        cfg = self.cfg
        return {"units": done, "iterations": done * cfg["itr"],
                "window_s": window,
                "least_s": done * work.solve_s(
                    self.traffic["norm"], cfg["m"], cfg["n"], cfg["k"],
                    cfg["itr"], cfg["precision"])}

    def release(self):
        """Frees the program's state; the sample of answers stays."""
        self.port = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self):
        pass

    def reference(self, tag, mm):
        """The reference's fit of the solve ``tag`` from its own draws."""
        W0, H0 = self._factors(tag)
        return ref.solve(self.A, W0, H0, self.traffic["norm"],
                         self.cfg["itr"], mm)

    def check(self) -> list:
        """The readings of each sampled answer against the reference's
        (float32)."""
        mm = ref.Products(tf32=False)
        return [compare.solve_numbers((W, H, err), self.reference(i, mm))
                for i, W, H, err in self.kept]

    def control(self) -> list:
        """The readings of the reference in TF32 against the reference in
        float32, on the sampled solves."""
        return [compare.solve_numbers(self.reference(i, ref.Products(True)),
                                      self.reference(i, ref.Products(False)))
                for i, *_ in self.kept]
