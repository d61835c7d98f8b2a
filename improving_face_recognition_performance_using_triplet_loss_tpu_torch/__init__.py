"""PyTorch + CUDA port of facejax: serving, extraction, triplet-head and
backbone training, LFW verification, alignment and checkpoint import.

A second package beside the JAX reference
(``improving_face_recognition_performance_using_triplet_loss_tpu``). It
imports ``torch`` and numpy only, never ``jax``, ``flax`` or the JAX
package, and mirrors that package's subpackages so every module has one
JAX twin:

- ``ops``     — MFM/EFM activations, distances, negative mining, box ops
                and NMS, the space-to-depth stem, the int8 inference
                route (``quantized``) and the im2col filter gradient
                (``conv_backward``); ``ops/cuda/`` holds the
                wrappers of the hand-written Hopper kernels whose CUDA C++
                sources live in ``csrc/``.
- ``models``  — MTCNN PNet/RNet/ONet, the 342-d EFM symbol ladder,
                LightCNN9 / LightCNN29, DeepFace, the BEGAN-CS generator
                and autoencoder-discriminator and the linear triplet head.
- ``losses``, ``train`` — the triplet, joint, center and BEGAN-CS losses,
                the backbone's, the head's and the BEGAN-CS train and eval
                steps, the optimizer families, checkpoints and the epoch
                loop.
- ``data``, ``eval`` — pair batching (in memory and streamed), feature and
                image stores, batch transforms, device prefetching,
                synthetic data, LFW pairs; the cosine-similarity sink and
                plots, the LFW verification protocol.
- ``detect``  — the MTCNN detector: its host cascade, the batched
                on-device cascade (``DeviceCascade``), dataset alignment,
                68-point ERT landmarks and the dlib ``.dat`` codec.
- ``serve``   — weight export/import, the fused recognition pipelines
                and their ahead-of-time export (``torch.export``,
                AOTInductor; the kernels as ``facejax`` ``torch.library``
                ops).
- ``utils``   — the MXNet ``.params`` reader / writer and mappings,
                tracing, timers and FLOP counts.
- ``cli``     — every command of the JAX package, and the ``python -m
                <package>.cli <command>`` dispatcher.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no CUDA present the default device raises.
"""

__version__ = "0.1.0"
