"""Serving: weight export/import and the fused recognition pipelines."""
