"""BEGAN-CS + triplet-consistency training.

The port's ``train_began``, with the JAX package's flags and defaults plus
``--device``: trains the BEGAN-CS generator and autoencoder-discriminator
on identity-labeled face images with the boundary-equilibrium game, the
CS latent constraint and the triplet loss on the encoder's embedding
space (``--mining semi_hard_fused`` mines with kernel B1 on the card).
Saves a sample grid every ``--sample-every`` epochs and at the end
(``samples_<epoch>.jpg``, cv2), the convergence-measure curve where
matplotlib is installed, and both players as exports (``export_gen``,
``export_disc``). Runs on ``cuda`` unless ``--device cpu`` is given.
``--data-parallel`` shards each batch over the ranks (each draws the
global batch from the seed and steps on its block; both players'
gradients are averaged over the ranks); only rank 0 writes samples, the
curve, the log and the exports.

    python -m improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.train_began \\
        --synthetic --epochs 2 --out-dir /tmp/began
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--images", help=".npz image store (images+labels)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-size", type=int, default=32)
    p.add_argument("--out-dir", default="runs/train_began")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--h-dim", type=int, default=64)
    p.add_argument("--filters", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--gamma", type=float, default=0.5)
    p.add_argument("--lambda-k", type=float, default=1e-3)
    p.add_argument("--lambda-cs", type=float, default=0.1)
    p.add_argument("--triplet-weight", type=float, default=0.1)
    p.add_argument("--triplet-margin", type=float, default=0.2)
    p.add_argument("--mining", default="random",
                   choices=["random", "semi_hard", "semi_hard_fused", "hard"])
    p.add_argument("--sample-every", type=int, default=10)
    p.add_argument("--data-parallel", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def save_sample_grid(images: np.ndarray, path: str, cols: int = 8) -> str:
    """Tile [N, H, W, C] in [-1, 1] into one jpg grid (README result format)."""
    import cv2

    n, h, w, c = images.shape
    cols = min(cols, n)
    rows = (n + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w, c), np.float32)
    for i in range(n):
        r, cl = divmod(i, cols)
        grid[r * h:(r + 1) * h, cl * w:(cl + 1) * w] = images[i]
    grid = ((grid + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
    if c == 1:
        grid = grid[..., 0]
    cv2.imwrite(path, grid if c == 1 else cv2.cvtColor(grid,
                                                       cv2.COLOR_RGB2BGR))
    return path


def main(argv=None):
    """Train; returns ``(state, [convergence a epoch])``."""
    args = build_parser().parse_args(argv)
    if args.data_parallel:
        from ..parallel import process_group, rank_device

        with process_group(args.device):
            return _main(args, rank_device(args.device))
    from ..device import resolve_device

    return _main(args, resolve_device(args.device))


def _main(args, device):
    import torch

    from ..data import PairBatcher
    from ..device import full_f32
    from ..models.began_cs import AutoencoderDiscriminator, Generator
    from ..serve.export import export_params
    from ..train.gan import (create_gan_state, make_began_cs_train_step,
                             shard_map_gan_step)
    from ..train.optim import adam
    from ._common import is_writer, local_batches, log_config, setup_logging
    from .train_backbone import load_images

    full_f32()
    log = setup_logging(os.path.join(args.out_dir, "log"), "train_began")
    log_config(log, args)

    images, labels, _ = load_images(args)
    # BEGAN trains on [-1, 1] RGB/gray images (uint8 mmap stores load raw)
    images = np.asarray(images, np.float32)
    if images.max() > 1.5:
        images = images / 255.0
    images = images * 2.0 - 1.0
    size = images.shape[1]
    channels = images.shape[3]
    batch = min(args.batch_size, images.shape[0])

    gen = torch.Generator().manual_seed(args.seed)
    generator = Generator(size, channels, args.filters, args.h_dim)
    discriminator = AutoencoderDiscriminator(size, channels, args.filters,
                                             args.h_dim)
    generator = generator.init_weights(gen).to(device)
    discriminator = discriminator.init_weights(gen).to(device)
    state = create_gan_state(generator, discriminator,
                             adam(args.lr, b1=0.5), adam(args.lr, b1=0.5),
                             args.seed)
    step = make_began_cs_train_step(
        h_dim=args.h_dim, gamma=args.gamma, lambda_k=args.lambda_k,
        lambda_cs=args.lambda_cs, triplet_weight=args.triplet_weight,
        triplet_margin=args.triplet_margin, mining_mode=args.mining,
        axis_name="data" if args.data_parallel else None)
    mesh = None
    if args.data_parallel:
        from ..parallel import make_mesh

        mesh = make_mesh()
        step = shard_map_gan_step(step, mesh)

    sample_z = (torch.rand((16, args.h_dim), generator=torch.Generator()
                           .manual_seed(args.seed + 1)) * 2.0 - 1.0).to(device)
    batcher = PairBatcher(images, labels, batch, shuffle=True, seed=args.seed)
    writer = is_writer()
    if writer:
        os.makedirs(args.out_dir, exist_ok=True)
    convergence = []
    for epoch in range(args.epochs):
        last = None
        for anc, pos, lab in local_batches(batcher, mesh):
            state, last = step(state, anc, pos, lab)
        if last is not None:
            convergence.append(float(last["convergence"]))
            log.info(
                "Epoch %d: M=%.4f d=%.4f g=%.4f cs=%.4f tl=%.4f k=%.4f",
                epoch, float(last["convergence"]), float(last["loss_d"]),
                float(last["loss_g"]), float(last["loss_cs"]),
                float(last["loss_triplet"]), float(last["k_t"]))
        if writer and ((epoch + 1) % args.sample_every == 0
                       or epoch == args.epochs - 1):
            with torch.no_grad():
                fake = state.generator(sample_z)
            save_sample_grid(fake.cpu().numpy(),
                             os.path.join(args.out_dir,
                                          f"samples_{epoch:04d}.jpg"))

    if not writer:
        return state, convergence
    if convergence and importlib.util.find_spec("matplotlib") is not None:
        from ..eval.plots import draw_curve

        draw_curve({"M": convergence}, "convergence measure",
                   os.path.join(args.out_dir, "convergence.jpg"))
    export_params(os.path.join(args.out_dir, "export_gen"),
                  state.generator.flax_params(),
                  model_name="began_cs_generator", feature_dim=args.h_dim,
                  input_hw=(size, size), input_channels=channels)
    export_params(os.path.join(args.out_dir, "export_disc"),
                  state.discriminator.flax_params(),
                  model_name="began_cs_discriminator",
                  feature_dim=args.h_dim, input_hw=(size, size),
                  input_channels=channels)
    log.info("done")
    return state, convergence


if __name__ == "__main__":
    main()
