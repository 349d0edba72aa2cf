"""The system under test, built from a configuration file through the
port's public entry points: ``discretize`` of the configured problem and
``model.make_online_step``.  Nothing here imports the JAX package.

A configuration's ``program`` block names the problem module, the
discretizer and the keywords of ``make_online_step``; ``theta`` gives the
affine map from a query's parameter to the operator's coefficients
(``const + mu * per_mu``) and ``theta_f`` the right-hand side's.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

KERNELS = "pylrbms_tpu_torch.ops.hopper_kernels"


class OnlineStep:
    def __init__(self, cfg: dict, device: torch.device):
        prog = cfg["program"]
        self.device = device
        self.dtype = getattr(torch, cfg["dtype"])
        problem = importlib.import_module(prog["problem"])
        disc = importlib.import_module(prog["discretizer"])
        model = importlib.import_module("pylrbms_tpu_torch.model")
        self.kernels = importlib.import_module(KERNELS)
        if device.type == "cuda":
            self.kernels.load()                        # build or load the hand kernels
        self.model, _ = disc.discretize(problem.init_grid_and_problem(dict(cfg["grid"])),
                                        device=device, dtype=self.dtype,
                                        order=cfg.get("order", 1))
        self.step = model.make_online_step(self.model, **prog["step"])
        form = "stencil" if "stencils" in self.step.arrays else "blocks"
        if form != prog["form"]:
            raise RuntimeError(f"the step took the {form} form, the configuration "
                               f"states {prog['form']!r}")
        th = cfg["theta"]
        self.theta_const = np.asarray(th["const"], np.float64)
        self.theta_mu = np.asarray(th["per_mu"], np.float64)
        self.theta_f = np.asarray(cfg["theta_f"], np.float64)
        self.parameter = cfg["parameter"]
        self.K, self.N = self.model.space.K, self.model.space.N

    def thetas(self, mus: np.ndarray):
        B = len(mus)
        return (self.theta_const + mus[:, None] * self.theta_mu,
                np.tile(self.theta_f, (B, 1)))

    def __call__(self, mus: np.ndarray):
        """Answer one batch: (U [B, K, N], indicators [B, K]) on the device."""
        theta, theta_f = self.thetas(mus)
        mu = {self.parameter: torch.as_tensor(mus[:, None], dtype=self.dtype, device=self.device)}
        return self.step(theta, theta_f, mu)

    def iterations(self, mus: np.ndarray) -> int:
        """The lock-step PCG iteration count of a batch (a solve of its own)."""
        return self.step.iters_probe(*self.thetas(mus))

    def release(self) -> None:
        """Drop the program's state (model, step and their device tensors)."""
        self.step = self.model = None

    def reset_launches(self) -> None:
        self.kernels.reset_launch_counts()

    def launches(self) -> dict:
        """{kernel: {(G, K, N, B, matrix dtype, vector dtype): launches}}."""
        return self.kernels.launch_signature_counts()
