"""Command-line entry points of the port: ``serve_demo --streams N``,
``extract_features``, ``train_backbone``, ``train_final``,
``pack_dataset``, ``train_head``, ``eval_cos``, ``draw_cos`` and
``slice_dataset``."""
