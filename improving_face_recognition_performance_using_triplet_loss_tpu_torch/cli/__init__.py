"""Command-line entry points of the port, one module per command of the
JAX package (``python -m <package>.cli <command>`` dispatches them, see
``__main__.py``); ``export_aot`` and ``train_began`` are not ported yet."""
