"""Data for the paper's applications (port of ``repro.data``).

synthetic  Gaussian-mixture stand-ins for MNIST / ISOLET / KDD / Iris,
           drawn from a ``torch.Generator``
"""
