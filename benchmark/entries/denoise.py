"""The entry point of the denoising cells: ``TVDenoiser(reg, cfg).cp`` or ``.gd`` of
the port on a tensor on the card, one solve per call, from the same noisy
volume each time (the solvers never modify their input).

Traffic parameters: ``solver`` (``'cp'`` or ``'gd'``), ``n_iter``,
``storage`` (the volume's dtype) and, for CP, ``dual`` (the TV dual's)."""

from __future__ import annotations

import torch

from .. import inputs
from ..reference import tv as ref_tv


class Runner:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from pytv4d_tpu_torch.core.config import TVConfig
        from pytv4d_tpu_torch.models.denoise import TVDenoiser

        self.config, self.seed, self.device = config, seed, device
        self.shape = tuple(config["shape"])
        self.solver = traffic["solver"]
        self.n_iter = int(traffic["n_iter"])
        self.storage = getattr(torch, traffic["storage"])
        self.cfg = TVConfig(scheme=config["scheme"],
                            reg_z_over_reg=config["reg_z_over_reg"],
                            reg_time=config["reg_time"])
        self.model = TVDenoiser(reg=config["reg"], cfg=self.cfg)
        self.kw = {}
        if self.solver == "cp":
            self.kw.update(config["cp"])
            if traffic["dual"] != traffic["storage"]:
                self.kw["dual_dtype"] = traffic["dual"]
        elif self.solver == "gd":
            self.kw["step_size"] = config["gd"]["step_size"]
        else:
            raise ValueError(f"unknown solver {self.solver!r}")
        self.noisy = inputs.noisy_volume(self.shape, seed, config,
                                         device).to(self.storage)
        self.grad = ref_tv.Gradient(config["scheme"], self.shape[0],
                                    self.shape[1], config["reg_z_over_reg"],
                                    config["reg_time"])
        self.work_per_solve = self.n_iter * self.noisy.numel()
        self.facts = {"shape": self.shape, "n_iter": self.n_iter,
                      "Nd": self.grad.Nd,
                      "bpe": self.noisy.element_size(),
                      "dual_bpe": getattr(torch, traffic.get(
                          "dual", traffic["storage"])).itemsize}

    def solve(self):
        """One timed call: ``(x, loss history)``, after a host read of the
        last loss."""
        fn = self.model.cp if self.solver == "cp" else self.model.gd
        res = fn(self.noisy, n_iter=self.n_iter, **self.kw)
        float(res.loss[-1])
        return res.x, res.loss

    def release(self):
        self.noisy = self.model = None

    def reference(self):
        """``(x_ref, ref_losses, x_start)``: the plain solve in float64 of
        the same input, made again from the seed."""
        x0 = inputs.noisy_volume(self.shape, self.seed, self.config,
                                 self.device).double()
        if self.solver == "cp":
            cp = self.config["cp"]
            x, losses = ref_tv.cp_denoise(
                x0, n_iter=self.n_iter, reg=self.config["reg"],
                grad=self.grad, sigma_D=cp["sigma_D"], sigma_A=cp["sigma_A"])
        else:
            x, losses = ref_tv.gd_denoise(
                x0, n_iter=self.n_iter, reg=self.config["reg"],
                step=self.config["gd"]["step_size"], grad=self.grad)
        return x, losses, x0


def prepare(config, traffic, seed, device):
    return Runner(config, traffic, seed, device)
