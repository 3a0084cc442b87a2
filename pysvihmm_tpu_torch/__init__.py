"""pysvihmm_tpu_torch: the PyTorch + CUDA port of pysvihmm_tpu.

Stochastic variational inference for Bayesian HMMs on an NVIDIA GPU. The
JAX package ``pysvihmm_tpu`` stays beside it as the reference that every
part of the port is tested against; this package imports neither it nor
JAX. It carries every engine of the JAX package for the four emission
families (batch VB, windowed subchain SVI, batch natural-gradient VB,
meta-observation SVI, Gibbs), the long-chain streaming tiers and the
parallel paths over ``torch.distributed`` (``parallel/``), over E-step
kernels written in CUDA (``csrc/*.cu``, built with nvcc at first use).
"""
