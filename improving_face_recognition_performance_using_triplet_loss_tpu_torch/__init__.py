"""PyTorch + CUDA port of facejax: serving, extraction, triplet-head and
backbone training.

A second package beside the JAX reference
(``improving_face_recognition_performance_using_triplet_loss_tpu``). It
imports ``torch`` and numpy only, never ``jax``, ``flax`` or the JAX
package, and mirrors that package's subpackages so every module has one
JAX twin:

- ``ops``     — MFM/EFM activations, distances, negative mining, box ops
                and NMS, the space-to-depth stem; ``ops/cuda/`` holds the
                wrappers of the hand-written Hopper kernels whose CUDA C++
                sources live in ``csrc/``.
- ``models``  — MTCNN PNet/RNet/ONet, the 342-d EFM symbol ladder,
                LightCNN9 / LightCNN29 and the linear triplet head.
- ``losses``, ``train`` — the triplet, joint and center losses, the
                backbone's and the head's train and eval steps, the
                optimizer families, checkpoints and the epoch loop.
- ``data``, ``eval`` — pair batching (in memory and streamed), feature and
                image stores, batch transforms, device prefetching,
                synthetic data; the cosine-similarity sink and plots.
- ``detect``  — the batched on-device MTCNN cascade.
- ``serve``   — weight export/import and the fused recognition pipelines.
- ``cli``     — ``serve_demo --streams N``, ``extract_features``,
                ``train_backbone``, ``train_final``, ``pack_dataset``,
                ``train_head``, ``eval_cos``, ``draw_cos``,
                ``slice_dataset``.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no CUDA present the default device raises.
"""

__version__ = "0.1.0"
