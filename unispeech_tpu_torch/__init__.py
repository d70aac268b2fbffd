"""PyTorch + CUDA port of the UniSpeech-family stack (H100).

Importing the package builds nothing: the CUDA kernels are compiled at their
first call (ops/kernels/_build.py).
"""
