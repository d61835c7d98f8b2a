"""Losses of the port: the triplet loss of the head slice."""
