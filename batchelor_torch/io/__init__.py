"""Checkpoints of the merge loop and the PCA stage."""
