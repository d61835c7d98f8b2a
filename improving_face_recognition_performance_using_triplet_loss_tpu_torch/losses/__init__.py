"""Losses of the port: triplet, softmax cross-entropy, the joint id +
triplet objective, center loss and the BEGAN-CS loss pieces."""
