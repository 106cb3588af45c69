"""The entry point of the CT cells: ``models.ct.cp_reconstruct`` of the port on a
sinogram on the card, one reconstruction per call, from the same sinogram
each time.  The benchmark makes the sinogram with its own plain projector
and fixes the operator norm once with its own power method, as a user
reconstructing a series in one geometry would; both are inputs handed to
the program and to the reference alike.

Traffic parameters: ``n_iter``, and ``precision`` for the projector's
matmuls (absent: the program's default)."""

from __future__ import annotations

import numpy as np
import torch

from .. import inputs
from ..reference import ct as ref_ct
from ..reference import tv as ref_tv


class Runner:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from pytv4d_tpu_torch.core.config import TVConfig
        from pytv4d_tpu_torch.models.ct import cp_reconstruct

        self.reconstruct = cp_reconstruct
        self.config, self.seed, self.device = config, seed, device
        self.shape = tuple(config["shape"])
        self.n_iter = int(traffic["n_iter"])
        self.angles = np.linspace(0.0, np.pi, config["n_angles"],
                                  endpoint=False).astype(np.float32)
        self.cfg = TVConfig(scheme=config["scheme"],
                            reg_z_over_reg=config["reg_z_over_reg"],
                            reg_time=config["reg_time"])
        self.kw = dict(n_iter=self.n_iter, reg=config["reg"], cfg=self.cfg,
                       n_det=config["n_det"], nonneg=config["nonneg"],
                       method=config["method"])
        if "precision" in traffic:
            self.kw["precision"] = traffic["precision"]
        pair = self._pair()
        self.sino = inputs.sinogram(pair, self.shape, seed, config, device)
        on = config["op_norm"]
        self.kw["op_norm"] = ref_ct.power_norm(pair, self.shape, on["n_iter"],
                                               on["seed"])
        del pair
        self.grad = ref_tv.Gradient(config["scheme"], self.shape[0],
                                    self.shape[1], config["reg_z_over_reg"],
                                    config["reg_time"])
        self.work_per_solve = self.n_iter * int(np.prod(self.shape))
        self.facts = {"shape": self.shape, "n_iter": self.n_iter,
                      "Nd": self.grad.Nd, "bpe": 4, "dual_bpe": 4}

    def _pair(self):
        return ref_ct.ParallelBeam(self.shape[-1], self.angles,
                                   self.config["n_det"], self.device)

    def solve(self):
        """One timed call: ``(x, loss history)``, after a host read of the
        last loss."""
        res = self.reconstruct(self.sino, self.angles, self.shape, **self.kw)
        float(res.loss[-1])
        return res.x, res.loss

    def release(self):
        self.sino = None

    def reference(self):
        """``(x_ref, ref_losses, None)``: the plain solve in float64 of the
        same sinogram, made again from the seed (it starts from zero)."""
        pair = self._pair()
        sino = inputs.sinogram(pair, self.shape, self.seed, self.config,
                               self.device)
        x, losses = ref_ct.cp_inverse(
            pair, sino, self.shape, n_iter=self.n_iter, reg=self.config["reg"],
            grad=self.grad, op_norm=self.kw["op_norm"],
            nonneg=self.config["nonneg"])
        return x, losses, None


def prepare(config, traffic, seed, device):
    return Runner(config, traffic, seed, device)
