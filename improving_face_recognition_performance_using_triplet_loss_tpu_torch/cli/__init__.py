"""Command-line entry points of the port: ``serve_demo --streams N``,
``train_head``, ``eval_cos``, ``draw_cos`` and ``slice_dataset``."""
