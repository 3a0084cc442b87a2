"""Build the C forward-backward oracle extension in place, mirroring the
reference's ``python setup.py build_ext --inplace`` workflow (SURVEY.md §2.2
"Build"). The package works without it (pure-NumPy fallback in
oracle/numpy_ref.py; the TPU compute path never uses it).
"""

from setuptools import Extension, setup

setup(
    name="pysvihmm_tpu",
    version="0.1.0",
    packages=[
        "pysvihmm_tpu",
        "pysvihmm_tpu.compat",
        "pysvihmm_tpu.data",
        "pysvihmm_tpu.distributions",
        "pysvihmm_tpu.engines",
        "pysvihmm_tpu.eval",
        "pysvihmm_tpu.messages",
        "pysvihmm_tpu.models",
        "pysvihmm_tpu.oracle",
        "pysvihmm_tpu.parallel",
        "pysvihmm_tpu.utils",
        "pysvihmm_tpu_torch",
        "pysvihmm_tpu_torch.data",
        "pysvihmm_tpu_torch.distributions",
        "pysvihmm_tpu_torch.engines",
        "pysvihmm_tpu_torch.eval",
        "pysvihmm_tpu_torch.messages",
        "pysvihmm_tpu_torch.models",
        "pysvihmm_tpu_torch.scripts",
        "pysvihmm_tpu_torch.utils",
    ],
    # the port's CUDA sources, compiled with nvcc at first use
    package_data={"pysvihmm_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    ext_modules=[
        Extension(
            "pysvihmm_tpu.oracle._fb_ext",
            sources=["pysvihmm_tpu/oracle/_fb_ext.c"],
            extra_compile_args=["-O3", "-std=c99"],
        )
    ],
)
