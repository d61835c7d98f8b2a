"""Evaluation: the cosine-similarity sink and its PDF/CDF, the plots, and
the LFW 10-fold verification protocol (``lfw``)."""
