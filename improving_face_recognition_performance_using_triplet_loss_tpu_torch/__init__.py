"""PyTorch + CUDA port of facejax: the serving path and triplet-head
training.

A second package beside the JAX reference
(``improving_face_recognition_performance_using_triplet_loss_tpu``). It
imports ``torch`` and numpy only, never ``jax``, ``flax`` or the JAX
package, and mirrors that package's subpackages so every module has one
JAX twin:

- ``ops``     — MFM/EFM activations, distances, negative mining, box ops
                and NMS, the space-to-depth stem; ``ops/cuda/`` holds the
                wrappers of the hand-written Hopper kernels whose CUDA C++
                sources live in ``csrc/``.
- ``models``  — MTCNN PNet/RNet/ONet, the 342-d EFM symbol ladder and the
                linear triplet head.
- ``losses``, ``train`` — the triplet loss, the head's train and eval
                steps, optimizer, checkpoints and epoch loop.
- ``data``, ``eval`` — pair batching, feature stores, synthetic features;
                the cosine-similarity sink and plots.
- ``detect``  — the batched on-device MTCNN cascade.
- ``serve``   — weight export/import and the fused recognition pipelines.
- ``cli``     — ``serve_demo --streams N``, ``train_head``, ``eval_cos``,
                ``draw_cos``, ``slice_dataset``.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no CUDA present the default device raises.
"""

__version__ = "0.1.0"
