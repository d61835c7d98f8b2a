"""Data of the port: positive-pair batching (in memory and streamed from
an mmap store), the feature store, the image store I/O and writer, the
training batch transforms, device prefetching and synthetic features and
faces (numpy copies of the JAX package's numpy modules)."""

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
from .records import (  # noqa: F401
    ImageStoreWriter,
    load_image_store,
    load_image_store_mmap,
    save_image_store,
    save_image_store_mmap,
)
from .streaming import ShardedPairBatcher, shard_bounds  # noqa: F401
from .synthetic import synthetic_faces, synthetic_features  # noqa: F401
