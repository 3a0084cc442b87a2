"""pysvihmm_tpu_torch: the PyTorch + CUDA port of pysvihmm_tpu.

Stochastic variational inference for Bayesian HMMs on an NVIDIA GPU. The
JAX package ``pysvihmm_tpu`` stays beside it as the reference that every
part of the port is tested against; this package imports neither it nor
JAX. It carries batch VB and windowed subchain SVI for the four emission
families, over E-step kernels written in CUDA (``csrc/*.cu``, built with
nvcc at first use).
"""
