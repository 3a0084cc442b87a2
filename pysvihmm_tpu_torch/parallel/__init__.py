"""Data-parallel training (port of ``pysvihmm_tpu/parallel``): so far the
streamed SVI step in its single-process form."""

from .data_parallel import make_dp_streamed_svi_step

__all__ = ["make_dp_streamed_svi_step"]
