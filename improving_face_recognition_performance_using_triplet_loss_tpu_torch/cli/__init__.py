"""Command-line entry points of the port, one module for each of the JAX
package's 17 commands (``python -m <package>.cli <command>`` dispatches
them, see ``__main__.py``)."""
