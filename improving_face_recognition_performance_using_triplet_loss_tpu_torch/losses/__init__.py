"""Losses of the port: triplet, softmax cross-entropy, the joint id +
triplet objective and center loss."""
