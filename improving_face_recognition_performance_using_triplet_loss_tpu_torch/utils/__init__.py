"""Utilities of the port: the reader and writer of MXNet ``.params``
checkpoints and their mapping onto the flax-layout trees of the export
(``mxnet_import``, a numpy copy of the JAX package's module)."""
