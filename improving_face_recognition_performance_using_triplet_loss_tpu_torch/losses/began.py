"""BEGAN / BEGAN-CS loss pieces (Berthelot 2017; Chang 2018).

Port of the JAX package's ``losses/began.py``:

- Autoencoder pixel loss: L(v) = mean |v - D(v)| (L1).
- Boundary equilibrium: L_D = L(x) - k_t L(G(z)); L_G = L(G(z));
  k_{t+1} = clip(k_t + lambda_k (gamma L(x) - L(G(z))), 0, 1).
- Convergence measure: M = L(x) + |gamma L(x) - L(G(z))|.
- CS constraint: L_cs = mean |z - Enc(G(z))| keeps the discriminator's
  latent space anchored to the generator's input space.
"""

from __future__ import annotations

import torch


def recon_l1(x: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x - recon))


def cs_constraint(z: torch.Tensor, z_recovered: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(z - z_recovered))


def k_update(k_t: torch.Tensor, loss_real: torch.Tensor,
             loss_fake: torch.Tensor, gamma: float = 0.5,
             lambda_k: float = 1e-3) -> torch.Tensor:
    balance = gamma * loss_real - loss_fake
    return torch.clamp(k_t + lambda_k * balance, 0.0, 1.0)


def convergence_measure(loss_real: torch.Tensor, loss_fake: torch.Tensor,
                        gamma: float = 0.5) -> torch.Tensor:
    return loss_real + torch.abs(gamma * loss_real - loss_fake)
