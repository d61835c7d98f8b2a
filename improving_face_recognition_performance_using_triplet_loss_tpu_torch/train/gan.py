"""BEGAN-CS training step with triplet-loss consistency.

Port of the JAX package's ``train/gan.py``. One step updates both players:

  L_D = L(x) - k_t L(G(z)) + lambda_cs |z - Enc(G(z))| + beta * TL(Enc(x))
  L_G = L(G(z))

with the boundary-equilibrium k_t update and the convergence measure M.
The discriminator's encoder doubles as the face-embedding net: the triplet
term (anchor / positive pairs and in-batch mined negatives, the backbone
step's ``_mine`` / ``_pool``; ``semi_hard_fused`` launches kernel B1)
shapes its latent space by identity. Both gradients are taken at the
step's starting weights, as the JAX step takes them, and each player's
optimizer steps on its own. ``z`` and ``random`` negatives are drawn from
the generator of ``(seed, step)`` (``train.state.step_generator``), not
JAX's keys. With ``axis_name`` (run through :func:`shard_map_gan_step`,
each rank calling it with its own rows) the step folds its data rank into
the generator, mines from the pool gathered over the axis, and averages
both players' gradients, the losses and the scalar metrics over it
before either optimizer steps; per-row cosines come back gathered in rank
order.
"""

from __future__ import annotations

import dataclasses

import torch

from ..losses.began import (convergence_measure, cs_constraint, k_update,
                            recon_l1)
from ..losses.triplet import triplet_loss
from ..ops.distances import rowwise_cosine
from ..parallel.collectives import pmean, reduce_tensors_
from ..parallel.mesh import DATA_AXIS, bound_axis
from .optim import OptimizerSpec
from .state import step_generator
from .steps import _fold, _mine, _pmean_metrics, _pool, shard_map_step

GAN_METRIC_KEYS = ("loss_d", "loss_g", "loss_real", "loss_fake", "loss_cs",
                   "loss_triplet", "k_t", "convergence", "pos_cos", "neg_cos")


@dataclasses.dataclass
class GANState:
    generator: torch.nn.Module
    gen_opt: torch.optim.Optimizer
    discriminator: torch.nn.Module
    disc_opt: torch.optim.Optimizer
    k_t: torch.Tensor
    seed: int
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.generator.parameters()).device


def create_gan_state(generator, discriminator, gen_tx: OptimizerSpec,
                     disc_tx: OptimizerSpec, seed: int) -> GANState:
    """Wrap the two initialised players, on one device, with their
    optimizers; ``k_t`` starts at 0."""
    dev = next(generator.parameters()).device
    return GANState(generator=generator,
                    gen_opt=gen_tx.build(generator.parameters()),
                    discriminator=discriminator,
                    disc_opt=disc_tx.build(discriminator.parameters()),
                    k_t=torch.zeros((), dtype=torch.float32, device=dev),
                    seed=int(seed))


def disc_loss(generator, discriminator, real, z, labels, k_t, *,
              lambda_cs: float = 0.1, triplet_weight: float = 0.1,
              triplet_margin: float = 0.2, mining_mode: str = "random",
              generator_rng: torch.Generator | None = None, data=None):
    """L_D at the players' current weights; returns ``(loss_d, aux)``
    (the loss pieces and the per-row cosines). The fake images carry no
    gradient into the generator. ``data``: the mining pool is gathered
    over that axis."""
    b = labels.shape[0]
    with torch.no_grad():
        fake = generator(z)
    recon_real, z_real = discriminator(real)
    recon_fake, z_fake = discriminator(fake)
    l_real = recon_l1(real, recon_real)
    l_fake = recon_l1(fake, recon_fake)
    l_cs = cs_constraint(z, z_fake)
    anc_e, pos_e = z_real[:b], z_real[b:]
    pool_feat, pool_labels = _pool(anc_e, pos_e, labels, data)
    neg_e = _mine(mining_mode, generator_rng, anc_e, pos_e, pool_feat,
                  labels, pool_labels)
    tl = triplet_loss(anc_e, pos_e, neg_e, margin=triplet_margin,
                      normalize=True)
    loss_d = l_real - k_t * l_fake + lambda_cs * l_cs + triplet_weight * tl
    with torch.no_grad():
        aux = {"loss_real": l_real.detach(), "loss_fake": l_fake.detach(),
               "loss_cs": l_cs.detach(), "loss_triplet": tl.detach(),
               "pos_cos": rowwise_cosine(anc_e, pos_e),
               "neg_cos": rowwise_cosine(anc_e, neg_e)}
    return loss_d, aux


def gen_loss(generator, discriminator, z) -> torch.Tensor:
    """L_G = L(G(z)) at the players' current weights."""
    fake = generator(z)
    recon_fake, _ = discriminator(fake)
    return recon_l1(fake, recon_fake)


def _set_grads(params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g


def make_began_cs_train_step(
    *,
    h_dim: int = 64,
    gamma: float = 0.5,
    lambda_k: float = 1e-3,
    lambda_cs: float = 0.1,
    triplet_weight: float = 0.1,
    triplet_margin: float = 0.2,
    mining_mode: str = "random",
    axis_name: str | None = None,
):
    """``step(state, anchor, positive, labels, z=None) -> (state,
    metrics)``; ``z`` [2B, h_dim] replaces the step's draw (the parity
    tests feed JAX's). After the step each parameter's ``.grad`` holds the
    gradient it was updated with. ``axis_name``: data parallelism (module
    docstring)."""

    def step(state: GANState, anchor, positive, labels, z=None):
        dev = state.device
        data = bound_axis(axis_name)
        gen = step_generator(state, _fold(data))
        real = torch.cat([torch.as_tensor(anchor, device=dev),
                          torch.as_tensor(positive, device=dev)]).float()
        labels = torch.as_tensor(labels, device=dev).to(torch.int32)
        if z is None:
            z = torch.rand((real.shape[0], h_dim), generator=gen,
                           device=dev) * 2.0 - 1.0
        z = torch.as_tensor(z, dtype=torch.float32, device=dev)
        g_model, d_model = state.generator, state.discriminator
        d_params = list(d_model.parameters())
        g_params = list(g_model.parameters())

        loss_d, aux = disc_loss(
            g_model, d_model, real, z, labels, state.k_t,
            lambda_cs=lambda_cs, triplet_weight=triplet_weight,
            triplet_margin=triplet_margin, mining_mode=mining_mode,
            generator_rng=gen, data=data)
        d_grads = torch.autograd.grad(loss_d, d_params)
        loss_g = gen_loss(g_model, d_model, z)
        g_grads = torch.autograd.grad(loss_g, g_params)
        if data is not None:
            reduce_tensors_(list(d_grads) + list(g_grads), data.group,
                            divide=data.size)
            loss_d, loss_g = pmean(loss_d, data.group), pmean(loss_g,
                                                              data.group)
            aux = _pmean_metrics(aux, data)
        _set_grads(d_params, d_grads)
        _set_grads(g_params, g_grads)
        state.disc_opt.step()
        state.gen_opt.step()
        with torch.no_grad():
            new_k = k_update(state.k_t, aux["loss_real"], aux["loss_fake"],
                             gamma, lambda_k)
            metrics = {"loss_d": loss_d.detach(), "loss_g": loss_g.detach(),
                       "k_t": new_k,
                       "convergence": convergence_measure(
                           aux["loss_real"], aux["loss_fake"], gamma),
                       **aux}
        state.k_t = new_k
        state.step += 1
        return state, metrics

    return step


def shard_map_gan_step(step_fn, mesh, axis_name: str = DATA_AXIS):
    """Run a GAN step built with ``axis_name`` over a data mesh: the
    players replicated, each rank calling the result with its own rows;
    scalar metrics averaged, ``pos_cos`` / ``neg_cos`` gathered in rank
    order."""
    return shard_map_step(step_fn, mesh, has_state_out=True,
                          metric_keys=GAN_METRIC_KEYS, axis_name=axis_name)
