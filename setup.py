"""Build orchestration — parity with the reference's setup.py (P40).

The reference gates each native extension behind an install flag
(``--cpp_ext``, ``--cuda_ext``, ``--xentropy``, ...; setup.py —
ext_modules.append(CUDAExtension(...))). Here the device-side kernels are
Pallas (no build step), so only the host-side C tier is gated:

    pip install -v --no-build-isolation --config-settings --build-option=--cpp_ext ./
    # or, in-tree:
    python setup.py build_ext --inplace --cpp_ext

Without ``--cpp_ext`` the package installs pure-Python and every native call
site falls back (the reference's graceful-degradation contract for missing
extensions).
"""

import sys

from setuptools import Extension, find_packages, setup

ext_modules = []

if "--cpp_ext" in sys.argv:
    sys.argv.remove("--cpp_ext")
    ext_modules.append(
        Extension(
            "apex_tpu._C",
            sources=["csrc/flatten_unflatten.c"],
            extra_compile_args=["-O3"],
        ))

# The reference's per-feature build flags (setup.py — "--cuda_ext",
# "--xentropy", ...) select which CUDA extensions compile. Their TPU
# equivalents are Pallas/XLA and need no build step, so reference install
# command lines are accepted verbatim: each flag is consumed (so setuptools
# doesn't choke) and noted as always-on.
_REFERENCE_FEATURE_FLAGS = [
    "--cuda_ext", "--xentropy", "--fast_multihead_attn", "--fast_layer_norm",
    "--bnp", "--fmha", "--transducer", "--peer_memory", "--nccl_p2p",
    "--fast_bottleneck", "--focal_loss", "--index_mul_2d",
    "--deprecated_fused_adam", "--deprecated_fused_lamb",
    "--permutation_search", "--group_norm", "--cudnn_gbn",
    "--nccl_allocator", "--gpu_direct_storage",
]
for _flag in _REFERENCE_FEATURE_FLAGS:
    if _flag in sys.argv:
        sys.argv.remove(_flag)
        print(f"apex_tpu setup: {_flag} accepted — this feature is "
              "always available (Pallas/XLA, no native build required)")

setup(
    name="apex_tpu",
    version="0.1.0",
    description="TPU-native mixed-precision, fused-kernel, and parallelism "
                "utilities (NVIDIA Apex capability surface on JAX/XLA/Pallas)",
    packages=find_packages(include=["apex_tpu", "apex_tpu.*",
                                    "apex_tpu_torch", "apex_tpu_torch.*"]),
    # per-device-kind tuned block files (kernels/tuned/<kind>.json),
    # auto-loaded by kernels.vmem at first dispatch; the PyTorch port's
    # CUDA sources, compiled with nvcc at first use on the GPU
    package_data={"apex_tpu.kernels": ["tuned/*.json"],
                  "apex_tpu_torch": ["csrc/*.cu"]},
    ext_modules=ext_modules,
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy"],
)
