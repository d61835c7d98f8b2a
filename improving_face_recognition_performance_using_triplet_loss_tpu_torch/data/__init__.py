"""Data of the head slice: positive-pair batching, the feature store and
synthetic features (numpy copies of the JAX package's modules)."""

from .feature_store import (  # noqa: F401
    load_feature_store,
    read_feature_csv,
    read_labels_csv,
    save_feature_store,
    split_identities,
    write_feature_csv,
    write_labels_csv,
)
from .pairs import PairBatcher, build_positive_index  # noqa: F401
from .synthetic import synthetic_features  # noqa: F401
