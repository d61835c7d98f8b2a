"""Face detection: the MTCNN detector with its host cascade, the batched
on-device cascade, and dataset alignment."""

from .pipeline import MTCNNDetector, detect_faces  # noqa: F401
