"""The benchmark of the PyTorch/CUDA port ``batchelor_torch`` on the card.

``run.py`` runs one cell; ``readings.py`` reads the numbers that the limits
of ``correct`` are set from. Nothing here imports JAX or the JAX package.
"""
