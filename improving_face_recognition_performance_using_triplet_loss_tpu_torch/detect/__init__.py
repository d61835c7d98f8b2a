"""Face detection: the MTCNN detector and its batched on-device cascade."""

from .pipeline import MTCNNDetector  # noqa: F401
