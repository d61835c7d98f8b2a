"""Evaluation: the cosine-similarity sink and its PDF/CDF, and the plots."""
