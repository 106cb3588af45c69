"""The entry point of the TGV cells: ``TVDenoiser(reg=alpha1).tgv`` of the
port on a tensor on the card, one solve per call, from the same noisy
volume each time (the solver never modifies its input).  A call keeps only
the solve's ``x`` and loss history: the rest of its result is the solver's
whole state, which kept across the next solve would double the peak.

Traffic parameters: ``n_iter``, ``compute_loss``, ``loss_every`` and
``storage`` (the volume's dtype)."""

from __future__ import annotations

import torch

from .. import inputs
from ..reference import tgv as ref_tgv


class Runner:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from pytv4d_tpu_torch.models.denoise import TVDenoiser

        if config["axes"] != "4d":
            raise ValueError("the TGV reference couples the four axes: "
                             f"axes must be '4d', got {config['axes']!r}")
        self.config, self.seed, self.device = config, seed, device
        self.shape = tuple(config["shape"])
        self.n_iter = int(traffic["n_iter"])
        self.model = TVDenoiser(reg=config["alpha1"])
        self.kw = dict(n_iter=self.n_iter, alpha0=config["alpha0"],
                       axes=config["axes"], norm=config["norm"],
                       sigma_tau_split=config["sigma_tau_split"],
                       compute_loss=bool(traffic["compute_loss"]),
                       loss_every=int(traffic["loss_every"]))
        self.noisy = inputs.noisy_volume(self.shape, seed, config, device).to(
            getattr(torch, traffic["storage"]))
        self.work_per_solve = self.n_iter * self.noisy.numel()
        self.facts = {"shape": self.shape, "n_iter": self.n_iter,
                      "mode": config["axes"],
                      "bpe": self.noisy.element_size()}

    def solve(self):
        """One timed call: ``(x, loss history)``, after a host read of the
        last loss."""
        res = self.model.tgv(self.noisy, **self.kw)
        x, loss = res.x, res.loss
        del res
        float(loss[-1])
        return x, loss

    def release(self):
        self.noisy = self.model = None

    def reference(self):
        """``(x_ref, ref_losses, x_start)``: the plain solve of the same
        input, made again from the seed, in the configuration's dtype; its
        losses where the program samples its own."""
        c = self.config
        x0 = inputs.noisy_volume(self.shape, self.seed, c, self.device).to(
            getattr(torch, c["dtype"]))
        x, _, losses = ref_tgv.tgv_denoise(
            x0, n_iter=self.n_iter, alpha1=c["alpha1"], alpha0=c["alpha0"],
            norm=c["norm"], sigma_tau_split=c["sigma_tau_split"])
        every = self.kw["loss_every"]
        return x, losses[every - 1::every] if every else losses, x0


def prepare(config, traffic, seed, device):
    return Runner(config, traffic, seed, device)
